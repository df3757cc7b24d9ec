"""PyTorch / CUDA port of the p(l)-CG system (``repro``) for NVIDIA Hopper.

The package mirrors ``repro``'s module names so each counterpart is easy to
find: ``core/plcg_scan.py`` is the scan engine, ``kernels/`` holds the
hand-written CUDA kernels that replace the Pallas TPU kernels, and
``core/engine.py`` / ``core/session.py`` are the front end.  It imports
``torch`` only -- never JAX, never ``repro`` -- so it runs where JAX is
absent.

Every entry point (``solve``, ``Solver``, ``plcg_solve``, ``plcg_scan``,
``repro_torch.launch.solve``) runs on the CUDA card by default
(``device="cuda"``) and raises when no card is present; pass
``device="cpu"`` to run the plain PyTorch versions on the host.
"""
