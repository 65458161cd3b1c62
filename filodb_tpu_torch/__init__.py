"""filodb_tpu_torch — the PyTorch and CUDA port of filodb_tpu.

A second package beside the JAX one, laid out like it (core/, ops/,
promql/, query/, parallel/, utils/) so every module's counterpart sits
under the same path.  It imports torch and numpy, never jax, and nothing
of filodb_tpu: what it needs from the JAX-free host modules it carries as
its own copies.  Hand-written CUDA kernels live in csrc/ and are built at
first use into build/ (ops/kernels.py).

Device rule: the entry points (TimeSeriesMemStore, QueryEngine,
DeviceMirror) take ``device=`` and default to ``"cuda"``.  Without a card
they raise unless the caller passes ``device="cpu"``.  The HTTP layer
(http/: PromHttpApi, FiloHttpServer) takes engines that already carry
their device.
"""

__version__ = "0.1.0"
