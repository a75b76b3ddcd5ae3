"""DetectMate on PyTorch and CUDA: the port of ``detectmateservice_tpu``.

Imports ``torch``, ``numpy`` and the standard library only; nothing of JAX
and nothing of the JAX package. Entry points run on ``cuda:0`` unless the
caller passes ``device: "cpu"``.
"""

__version__ = "0.5.0"
