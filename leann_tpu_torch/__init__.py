"""LEANN on PyTorch and CUDA: the port of `leann_tpu` to one NVIDIA H100.

The package keeps the module names and public signatures of `leann_tpu`
so each piece has an obvious counterpart, and imports nothing of it (nor
of JAX): the host modules it needs (`store/`, `index/{bm25,filter,query}`,
`embed/fake`, `utils/`) are its own copies, reading and writing the same
index files byte for byte.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`device.py`). The fused graph traversal (`ops/fused_beam.py`) is a
hand-written CUDA kernel (`csrc/fused_beam.cu`) built with nvcc on first
use; on CPU tensors the same wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
