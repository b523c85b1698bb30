// Native TFLite flatbuffer parser (C++ equivalent of the reference's
// native compiler front-end -- the Rust proc-macro + flatc-generated
// bindings, microflow-macros/src/lib.rs + flatbuffers/tflite_generated.rs).
//
// Walks the flatbuffer vtables directly (no flatbuffers dependency) and
// emits a JSON description of subgraph 0: its name, tensors (shape, dtype,
// quant params, byte offset+length of the weight payload inside the file for
// zero-copy numpy mapping), operators (builtin code, io, decoded builtin
// options), and the subgraph io lists.
//
// C ABI:
//   int mf_parse_tflite(const uint8_t* buf, size_t len,
//                       char* out, size_t out_cap);
// Returns the number of bytes written (excluding NUL), or -1 on parse
// error, or the required capacity as a negative number -2-n if out_cap
// is too small.
//
// The port's copy of microflow_tpu/native/tflite_parser.cpp, with the same
// C ABI.  It adds two things: the subgraph's name, which the Python reader
// keeps too, so both readers give the same graph; and bounds checks: every
// read, and every weight payload, must lie inside the buffer, so a
// truncated or corrupt file returns -1 instead of reading past its end.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Reader {
  const uint8_t* buf;
  size_t len;

  bool ok(size_t pos, size_t n) const { return pos <= len && n <= len - pos; }

  template <typename T>
  T read(size_t pos) const {
    if (!ok(pos, sizeof(T))) throw std::out_of_range("read past the end of the model");
    T v;
    std::memcpy(&v, buf + pos, sizeof(T));  // little-endian host assumed
    return v;
  }
};

struct Table {
  const Reader* r;
  size_t pos;  // table start

  // absolute position of field, or 0 if absent
  size_t field(int id) const {
    int32_t soffset = r->read<int32_t>(pos);
    size_t vtable = pos - soffset;
    uint16_t vsize = r->read<uint16_t>(vtable);
    size_t entry = 4 + 2 * id;
    if (entry >= vsize) return 0;
    uint16_t off = r->read<uint16_t>(vtable + entry);
    return off ? pos + off : 0;
  }

  int64_t scalar_i(int id, int width, int64_t dflt) const {
    size_t p = field(id);
    if (!p) return dflt;
    switch (width) {
      case 1: return r->read<int8_t>(p);
      case 4: return r->read<int32_t>(p);
      case 8: return r->read<int64_t>(p);
    }
    return dflt;
  }

  uint32_t scalar_u32(int id, uint32_t dflt) const {
    size_t p = field(id);
    return p ? r->read<uint32_t>(p) : dflt;
  }

  size_t indirect(size_t p) const { return p + r->read<uint32_t>(p); }

  Table table(int id) const {
    size_t p = field(id);
    return Table{r, p ? indirect(p) : 0};
  }

  // (payload_pos, count) of a vector field
  std::pair<size_t, uint32_t> vec(int id) const {
    size_t p = field(id);
    if (!p) return {0, 0};
    size_t v = indirect(p);
    uint32_t n = r->read<uint32_t>(v);
    return {v + 4, n};
  }

  Table vec_table(size_t payload, uint32_t i) const {
    size_t slot = payload + 4 * i;
    return Table{r, indirect(slot)};
  }
};

struct Json {
  std::string s;
  void raw(const char* t) { s += t; }
  void num(int64_t v) { s += std::to_string(v); }
  void numf(float v) {
    char tmp[64];
    snprintf(tmp, sizeof tmp, "%.9g", v);
    s += tmp;
  }
};

template <typename T>
void emit_num_vec(Json& j, const Reader& r, const Table& t, int id, bool as_float = false) {
  auto [payload, n] = t.vec(id);
  j.raw("[");
  for (uint32_t i = 0; i < n; i++) {
    if (i) j.raw(",");
    if (as_float)
      j.numf(r.read<float>(payload + i * sizeof(T)));
    else
      j.num(r.read<T>(payload + i * sizeof(T)));
  }
  j.raw("]");
}

// a string field as a JSON string (null if absent); bytes from 0x80 up
// pass through, so the UTF-8 the Python reader decodes comes out the same
void emit_string(Json& j, const Reader& r, const Table& t, int id) {
  size_t p = t.field(id);
  if (!p) {
    j.raw("null");
    return;
  }
  size_t v = t.indirect(p);
  uint32_t n = r.read<uint32_t>(v);
  if (!r.ok(v + 4, n)) throw std::out_of_range("string past the end of the model");
  j.raw("\"");
  for (uint32_t i = 0; i < n; i++) {
    unsigned char c = r.buf[v + 4 + i];
    if (c == '"' || c == '\\') {
      j.s += '\\';
      j.s += (char)c;
    } else if (c < 0x20) {
      char tmp[8];
      snprintf(tmp, sizeof tmp, "\\u%04x", c);
      j.s += tmp;
    } else {
      j.s += (char)c;
    }
  }
  j.raw("\"");
}

}  // namespace

static int parse_tflite(const uint8_t* buf, size_t len, char* out, size_t out_cap) {
  if (len < 8) return -1;
  Reader r{buf, len};
  if (std::memcmp(buf + 4, "TFL3", 4) != 0) return -1;
  Table model{&r, r.read<uint32_t>(0)};

  Json j;
  j.raw("{\"version\":");
  j.num(model.scalar_u32(0, 0));

  // operator_codes (field 1): deprecated_builtin_code(0), version(2),
  // builtin_code(3)
  j.raw(",\"operator_codes\":[");
  {
    auto [payload, n] = model.vec(1);
    for (uint32_t i = 0; i < n; i++) {
      if (i) j.raw(",");
      Table oc = model.vec_table(payload, i);
      int64_t dep = oc.scalar_i(0, 1, 0);
      int64_t bc = oc.scalar_i(3, 4, 0);
      j.raw("{\"code\":");
      j.num(dep > bc ? dep : bc);
      j.raw("}");
    }
  }
  j.raw("]");

  // buffers (field 4): record offset+len of each data payload
  std::vector<std::pair<size_t, uint32_t>> buffers;
  {
    auto [payload, n] = model.vec(4);
    for (uint32_t i = 0; i < n; i++) {
      Table b = model.vec_table(payload, i);
      auto [dp, dn] = b.vec(0);
      if (!r.ok(dp, dn)) return -1;
      buffers.push_back({dp, dn});
    }
  }

  // subgraph 0 (field 2); count emitted so the front-end can reject
  // multi-subgraph models loudly instead of silently taking index 0
  auto [sg_payload, sg_n] = model.vec(2);
  if (!sg_n) return -1;
  Table sg = model.vec_table(sg_payload, 0);
  j.raw(",\"num_subgraphs\":");
  j.num((int64_t)sg_n);
  j.raw(",\"name\":");
  emit_string(j, r, sg, 4);

  j.raw(",\"tensors\":[");
  {
    auto [payload, n] = sg.vec(0);
    for (uint32_t i = 0; i < n; i++) {
      if (i) j.raw(",");
      Table t = sg.vec_table(payload, i);
      j.raw("{\"shape\":");
      emit_num_vec<int32_t>(j, r, t, 0);
      j.raw(",\"type\":");
      j.num(t.scalar_i(1, 1, 0));
      uint32_t bufidx = t.scalar_u32(2, 0);
      j.raw(",\"data_offset\":");
      j.num(bufidx < buffers.size() ? (int64_t)buffers[bufidx].first : 0);
      j.raw(",\"data_len\":");
      j.num(bufidx < buffers.size() ? (int64_t)buffers[bufidx].second : 0);
      Table q = t.table(4);
      j.raw(",\"scale\":");
      if (q.pos)
        emit_num_vec<float>(j, r, q, 2, true);
      else
        j.raw("[]");
      j.raw(",\"zero_point\":");
      if (q.pos)
        emit_num_vec<int64_t>(j, r, q, 3);
      else
        j.raw("[]");
      j.raw(",\"quantized_dimension\":");
      j.num(q.pos ? q.scalar_i(6, 4, 0) : 0);
      j.raw("}");
    }
  }
  j.raw("]");

  j.raw(",\"inputs\":");
  emit_num_vec<int32_t>(j, r, sg, 1);
  j.raw(",\"outputs\":");
  emit_num_vec<int32_t>(j, r, sg, 2);

  // operators (field 3): opcode_index(0), inputs(1), outputs(2),
  // builtin_options_type(3), builtin_options(4)
  j.raw(",\"operators\":[");
  {
    auto [payload, n] = sg.vec(3);
    for (uint32_t i = 0; i < n; i++) {
      if (i) j.raw(",");
      Table op = sg.vec_table(payload, i);
      j.raw("{\"opcode_index\":");
      j.num(op.scalar_u32(0, 0));
      j.raw(",\"inputs\":");
      emit_num_vec<int32_t>(j, r, op, 1);
      j.raw(",\"outputs\":");
      emit_num_vec<int32_t>(j, r, op, 2);
      int64_t ot = op.scalar_i(3, 1, 0);
      j.raw(",\"options_type\":");
      j.num(ot);
      Table o = op.table(4);
      j.raw(",\"options\":{");
      if (o.pos) {
        switch (ot) {
          case 1:  // Conv2DOptions
            j.raw("\"padding\":");
            j.num(o.scalar_i(0, 1, 0));
            j.raw(",\"stride_w\":");
            j.num(o.scalar_i(1, 4, 0));
            j.raw(",\"stride_h\":");
            j.num(o.scalar_i(2, 4, 0));
            j.raw(",\"fused_activation_function\":");
            j.num(o.scalar_i(3, 1, 0));
            j.raw(",\"dilation_w_factor\":");
            j.num(o.scalar_i(4, 4, 1));
            j.raw(",\"dilation_h_factor\":");
            j.num(o.scalar_i(5, 4, 1));
            break;
          case 2:  // DepthwiseConv2DOptions
            j.raw("\"padding\":");
            j.num(o.scalar_i(0, 1, 0));
            j.raw(",\"stride_w\":");
            j.num(o.scalar_i(1, 4, 0));
            j.raw(",\"stride_h\":");
            j.num(o.scalar_i(2, 4, 0));
            j.raw(",\"depth_multiplier\":");
            j.num(o.scalar_i(3, 4, 0));
            j.raw(",\"fused_activation_function\":");
            j.num(o.scalar_i(4, 1, 0));
            j.raw(",\"dilation_w_factor\":");
            j.num(o.scalar_i(5, 4, 1));
            j.raw(",\"dilation_h_factor\":");
            j.num(o.scalar_i(6, 4, 1));
            break;
          case 5:  // Pool2DOptions
            j.raw("\"padding\":");
            j.num(o.scalar_i(0, 1, 0));
            j.raw(",\"stride_w\":");
            j.num(o.scalar_i(1, 4, 0));
            j.raw(",\"stride_h\":");
            j.num(o.scalar_i(2, 4, 0));
            j.raw(",\"filter_width\":");
            j.num(o.scalar_i(3, 4, 0));
            j.raw(",\"filter_height\":");
            j.num(o.scalar_i(4, 4, 0));
            j.raw(",\"fused_activation_function\":");
            j.num(o.scalar_i(5, 1, 0));
            break;
          case 11:  // AddOptions
            j.raw("\"fused_activation_function\":");
            j.num(o.scalar_i(0, 1, 0));
            break;
          case 8:  // FullyConnectedOptions
            j.raw("\"fused_activation_function\":");
            j.num(o.scalar_i(0, 1, 0));
            j.raw(",\"keep_num_dims\":");
            j.num(o.scalar_i(2, 1, 0));
            break;
          default:
            break;
        }
      }
      j.raw("}}");
    }
  }
  j.raw("]}");

  if (j.s.size() + 1 > out_cap) return -2 - (int)j.s.size();
  std::memcpy(out, j.s.c_str(), j.s.size() + 1);
  return (int)j.s.size();
}

extern "C" int mf_parse_tflite(const uint8_t* buf, size_t len, char* out, size_t out_cap) {
  try {
    return parse_tflite(buf, len, out, out_cap);
  } catch (const std::exception&) {  // a read past the end, or out of memory
    return -1;
  }
}

// ---------------------------------------------------------------------------
// Requantization-constant folding (native equivalent of the reference
// compiler's preprocess() steps, microflow-macros/src/ops/*.rs -- C5-C8 in
// SURVEY.md).  All float arithmetic is plain f32 in the same association
// order as the Rust code (and as compiler/folding.py), so the constants
// are bit-identical across the native and Python folds.

extern "C" void mf_fold_fc(
    float in_scale, int32_t in_zp,
    float w_scale, int32_t w_zp,
    float bias_scale, int64_t bias_zp,
    float out_scale,
    const int32_t* bias, int32_t n,
    const int8_t* weights, int32_t k,  // [K, N] row-major (runtime layout)
    float* c0_out, float* c1_out, int32_t* c2_out, int32_t* c3_out) {
  // C0[j] = bias_scale/out_scale * (bias[j] - bias_zp)
  // (fully_connected.rs:96-119)
  float s = bias_scale / out_scale;
  for (int32_t j = 0; j < n; ++j) {
    c0_out[j] = s * (float)((int64_t)bias[j] - bias_zp);
  }
  // C1 = in_scale * w_scale / out_scale  (left-assoc)
  *c1_out = in_scale * w_scale / out_scale;
  // C2[j] = colsum(W)[j] * in_zp   (i64 accumulate, i32 result)
  for (int32_t j = 0; j < n; ++j) {
    int64_t acc = 0;
    for (int32_t r = 0; r < k; ++r) acc += (int64_t)weights[(size_t)r * n + j];
    c2_out[j] = (int32_t)(acc * in_zp);
  }
  // C3 = K * in_zp * w_zp
  *c3_out = (int32_t)((int64_t)k * in_zp * w_zp);
  (void)in_zp;
}

extern "C" void mf_fold_conv(
    float in_scale, float out_scale,
    const float* w_scales, int32_t n_wq,
    const float* bias_scales, int32_t n_bs,
    const int64_t* bias_zps, int32_t n_bz,
    const int32_t* bias, int32_t n_filters,
    float* c0_out, float* c1_out) {
  // C0[b] = bias_scale[b]/out_scale * (bias[b] - bias_zp[b]); per-channel
  // params fall back to entry 0 (the reference .get(b).unwrap_or(p[0])
  // pattern, conv_2d.rs:90-110 / depthwise_conv_2d.rs:96-116)
  // scale and zero_point arrays may have different lengths (a model may
  // carry per-channel scales with a single zero_point); each falls back
  // to its own entry 0 independently, like the numpy oracle's _get()
  for (int32_t b = 0; b < n_filters; ++b) {
    float bs = bias_scales[b < n_bs ? b : 0];
    int64_t bz = bias_zps[b < n_bz ? b : 0];
    c0_out[b] = bs / out_scale * (float)((int64_t)bias[b] - bz);
  }
  // C1[q] = in_scale * w_scale[q] / out_scale
  for (int32_t q = 0; q < n_wq; ++q) {
    c1_out[q] = in_scale * w_scales[q] / out_scale;
  }
}

extern "C" void mf_fold_avgpool(
    float in_scale, int32_t in_zp, float out_scale, int32_t out_zp,
    float* c0_out, float* c1_out) {
  // average_pool_2d.rs:73-79
  *c0_out = in_scale / out_scale;
  *c1_out = (float)out_zp - (in_scale * (float)in_zp) / out_scale;
}
