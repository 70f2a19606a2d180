"""The probes: small measurements of the card that answer the questions the
JAX package's ``tools/probe_*.py`` asked of the TPU, each on the kernels of
``kernels/probes.py`` (``csrc/probes.cu``).  Each module has ``run(device)``,
which returns its numbers as a dict (``chip_smoke.py`` calls it), and a
``main()``:

    python -m simpledsp_tpu_torch.tools.probe_dma_scale

They need a CUDA device and raise without one.
"""
