"""PyTorch/CUDA port of the ``repro`` serving system.

Imports ``torch`` and never ``jax`` or ``repro``; ``repro`` stays the
reference the port is held against in ``tests/test_torch_*.py``. Entry
points (``build_model``, ``LLMEngine``, ``launch/serve.py``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
