"""PyTorch/CUDA port of the Historical Graph Store and its LM stack.

Mirrors the ``repro`` package's layout (``core/``, ``storage/``, ``taf/``,
``data/``, ``kernels/<name>/``) and runs on one NVIDIA H100: Algorithm 1's
node fold and the triangle program of the plan compiler go through CUDA
kernels written for ``sm_90a`` (``kernels/delta_overlay``,
``kernels/temporal_motif``), and the dense analytics and the LM serving
path (``configs/``, ``models/``, ``train/``, ``launch/serve.py``) run
their kernels there too.  Entry points take ``device=``; the default
is the CUDA card, and a call without a card raises unless it asks for
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
