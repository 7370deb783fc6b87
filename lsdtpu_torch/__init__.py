"""lsdtpu_torch: the line-feature localization engine in PyTorch for one
NVIDIA Hopper card (H100).

A second package beside ``lsdtpu/`` (the JAX reference, which this
package never imports).  Plain tensor code is PyTorch; the kernels are
hand-written CUDA C++ for ``sm_90a`` in three sources, each built with
nvcc and bound with ctypes (``ops/build.py``): ``csrc/score.cu``, the
CalcScore kernel that scores candidates on the per-frame path, one frame
or a batch of lanes a launch (``ops/score.py``); ``csrc/nfa.cu``, the
NFA rectangle count of map prep (``ops/nfa.py``); and ``csrc/grow.cu``,
the FIFO region growth and radius reducer of map prep
(``ops/grow.py``).  Every entry point takes an explicit ``device``
argument that defaults to ``"cuda"``; the CPU is used only when the
caller passes ``device="cpu"`` (the tests do), and asking for the card
where there is none raises.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The torch.device for an entry point's ``device`` argument.

    Raises RuntimeError for a CUDA device when no card is present: the
    port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
