"""Kernels of the port: hand-written CUDA C++ for Hopper (``csrc/``), their
ctypes launchers (``multidot``, ``window_axpy``, ``fused_body``), their
plain PyTorch versions (``ref``) and the device dispatch (``ops``).

``LAUNCHES`` counts the CUDA launches of each kernel wrapper (one per call
that launches the kernel, nowhere else), so a run can show that its main
path went through the kernels.  Read it with :func:`launch_counts`, zero
it with :func:`reset_launch_counts`.
"""

LAUNCHES = {"fused_body": 0, "multidot": 0, "window_axpy": 0}


def launch_counts() -> dict:
    """Snapshot of the per-kernel CUDA launch counters."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
