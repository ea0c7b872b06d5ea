"""EasyRider in PyTorch: the port of ``repro`` (JAX/Pallas on a TPU) to
PyTorch with hand-written CUDA kernels for the NVIDIA H100.

The layout mirrors ``repro``: ``core`` (PDU, controller, health, fleet,
compliance), ``power`` (workload scenarios and traces), ``kernels`` (the
CUDA kernels, their plain PyTorch versions and the ``ops`` dispatch),
``configs`` (model configs for workload derivation) and ``utils``.  This
package imports neither JAX nor ``repro``; ``convert`` carries the JAX
package's objects across as numpy dicts.

Entry points that create tensors default to ``device="cuda"`` and raise
when no card is present.
"""
