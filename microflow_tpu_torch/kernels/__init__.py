"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
torch version (``*_reference``) for CPU tensors; there is no fallback from
one to the other.  ``qgemm`` and ``qdwconv`` are per-op kernels (backend
``"pallas"``); ``build_flat_kernel`` and ``build_col_kernel`` plan a whole
network into one kernel (backends ``"flat"`` and ``"colfc"``),
``build_fused_forward`` plans segments of layers into launches of the
megakernel (``"fused"``, ``"hybrid"``) and ``build_packed_kernel`` a
depthwise/pointwise prefix into one launch (``"packed"``).
``qadd`` (``kernels/qadd.py``) and ``qsoftmax`` (``kernels/qsoftmax.py``)
are per-op kernels too, for a graph's ``ADD`` and the softmax; they are
imported where they run, not here.
``LAUNCHES`` counts kernel launches by name, so a run can show that its
main path went through the kernels (``utils/trace.py`` keeps it beside
the port's other counters and its spans).
"""

from ..utils.trace import LAUNCHES

from .colfc import build_col_kernel, colfc_reference
from .flatpack import build_flat_kernel, flat_forward_reference
from .megakernel import build_fused_forward, segment_reference
from .packed import build_packed_kernel, packed_reference
from .qdwconv import qdwconv, qdwconv_reference
from .qgemm import qgemm, qgemm_reference

__all__ = ["LAUNCHES", "build_col_kernel", "build_flat_kernel", "build_fused_forward",
           "build_packed_kernel", "colfc_reference", "flat_forward_reference",
           "packed_reference", "qdwconv", "qdwconv_reference", "qgemm", "qgemm_reference",
           "segment_reference"]
