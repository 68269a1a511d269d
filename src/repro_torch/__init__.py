"""PyTorch/CUDA port of the R&B photonic-inference system (``repro``).

The package mirrors the JAX package's module names so each counterpart is
easy to find (``repro_torch.core.prepared`` <-> ``repro.core.prepared``).
It imports ``torch`` and never ``jax`` nor anything of ``repro``.  The two
TPU kernels on the serving path are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built at first use by ``kernels/build.py``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (the CPU tests do); on the CPU every kernel wrapper takes
its plain PyTorch version.
"""
