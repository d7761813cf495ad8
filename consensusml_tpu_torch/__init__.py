"""PyTorch + CUDA port of ``consensusml_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here
mirrors a module there (``models/``, ``serve/``, ``serve/pool/``,
``configs/``) and is held against it by the ``tests/test_torch_*.py``
parity tests. This package imports ``torch`` and ``numpy`` only — never
``jax`` nor anything of ``consensusml_tpu``.

Each Pallas kernel of the reference becomes a hand-written CUDA kernel
in ``csrc/`` (built with ``nvcc`` for ``sm_90a`` at first use, loaded
with ``ctypes``; see :mod:`consensusml_tpu_torch.kernels`), with a plain
PyTorch version of the same function beside its wrapper. A wrapper runs
the plain version only for tensors on the CPU; a CUDA tensor launches
the kernel or raises.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`consensusml_tpu_torch.device.resolve_device`).
"""
