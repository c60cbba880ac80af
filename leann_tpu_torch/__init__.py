"""LEANN on PyTorch and CUDA: the port of `leann_tpu` to one NVIDIA H100.

The package keeps the module names and public signatures of `leann_tpu`
so each piece has an obvious counterpart, and imports nothing of it (nor
of JAX): the host modules it needs (`store/`, `index/{bm25,filter,query}`,
`embed/`, `llm/`, `chunker/`, `config.py`, `cli/common.py`, `utils/`,
`native/` with its C++ source `csrc/leann_native.cpp`) are its own
copies, reading and writing the same index files byte for byte.
`api.py` (`Index`, `open_index`) is the library surface, with `rag/` and
`agent/` over it.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`device.py`). The fused graph traversal (`ops/fused_beam.py`) is a
hand-written CUDA kernel (`csrc/fused_beam.cu`) built with nvcc on first
use; on CPU tensors the same wrapper runs its plain PyTorch version.
"""

from leann_tpu_torch.version import __version__

__all__ = ["__version__", "Index", "open_index", "SearchResult"]


def __getattr__(name):
    # Lazy: `import leann_tpu_torch` stays free of torch, CUDA
    # initialisation and any nvcc build until an API symbol is touched.
    if name in ("Index", "open_index"):
        from leann_tpu_torch import api

        return getattr(api, name)
    if name == "SearchResult":
        from leann_tpu_torch.index.searcher import SearchResult

        return SearchResult
    raise AttributeError(f"module 'leann_tpu_torch' has no attribute {name!r}")
