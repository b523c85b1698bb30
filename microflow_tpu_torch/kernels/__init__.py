"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
torch version (``*_reference``) for CPU tensors; there is no fallback from
one to the other.  ``LAUNCHES`` counts kernel launches by name, so a run
can show that its main path went through the kernels.
"""

from collections import Counter

LAUNCHES: Counter = Counter()

from .qdwconv import qdwconv, qdwconv_reference  # noqa: E402
from .qgemm import qgemm, qgemm_reference  # noqa: E402

__all__ = ["LAUNCHES", "qdwconv", "qdwconv_reference", "qgemm", "qgemm_reference"]
