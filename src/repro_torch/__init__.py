"""repro_torch — the PyTorch/CUDA port of ``repro``.

It mirrors ``repro``'s module names, so each module here has one reference
module there. The Monte Carlo moments kernel is CUDA C++ for Hopper
(``kernels/csrc/mc_paths.cu``); everything else is plain PyTorch, numpy
and SciPy. Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU the kernel's plain PyTorch version runs.
"""
