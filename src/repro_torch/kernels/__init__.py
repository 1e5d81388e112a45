"""repro_torch.kernels — the hand-written CUDA kernel and its plain versions.

    prng      Threefry-2x32, uniforms, Box-Muller (plain PyTorch)
    mc_paths  family-batched Monte Carlo moments: CUDA wrapper + plain version
    ops       device-dispatching wrappers (kernel on CUDA, plain on the CPU)
    ref       per-task oracle over ``pricing.mc.path_stats``
"""
