"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
torch version (``*_reference``) for CPU tensors; there is no fallback from
one to the other.  ``qgemm`` and ``qdwconv`` are per-op kernels (backend
``"pallas"``); ``build_flat_kernel`` and ``build_col_kernel`` plan a whole
network into one kernel (backends ``"flat"`` and ``"colfc"``).
``LAUNCHES`` counts kernel launches by name, so a run can show that its
main path went through the kernels.
"""

from collections import Counter

LAUNCHES: Counter = Counter()

from .colfc import build_col_kernel, colfc_reference  # noqa: E402
from .flatpack import build_flat_kernel, flat_forward_reference  # noqa: E402
from .qdwconv import qdwconv, qdwconv_reference  # noqa: E402
from .qgemm import qgemm, qgemm_reference  # noqa: E402

__all__ = ["LAUNCHES", "build_col_kernel", "build_flat_kernel", "colfc_reference",
           "flat_forward_reference", "qdwconv", "qdwconv_reference", "qgemm", "qgemm_reference"]
