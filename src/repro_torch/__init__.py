"""GridSim in PyTorch: the port of ``repro`` to PyTorch and CUDA.

The package mirrors ``repro`` module for module (``core/<name>.py``,
``kernels/<name>.py``) and imports only ``torch`` and ``numpy``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version.
"""
