"""Time one kernel of several checkouts in turns on one GPU.

    python3 chip_ab.py KERNEL DIR [DIR ...]

KERNEL names an entry of ``TIMED`` (so far ``rglru_scan``). Each DIR is
the root of a checkout of this repository (for example a ``git archive``
of a commit, unpacked); give a parent and a change as parent, change,
change, parent. For each DIR, in the order given, a fresh interpreter
imports that checkout's wrapper of the kernel (which builds the kernel
from that checkout's source), checks it against its plain version, and
times it with a cold L2 by this checkout's ``chip_smoke.cuda_ms`` at the
entry's shapes. It prints one JSON line per checkout, then the card's
name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys

from chip_smoke import RGLRU_TIMED, cuda_ms


def time_rglru_scan():
    """``rglru_scan`` with h0 at ``chip_smoke.RGLRU_TIMED`` (the hybrid's
    prefill buckets and B = 4): a in [0.5, 0.999], b and h0 in [-0.2,
    0.2]; checked at [1, 2048, 4096] (f32 atol 2e-5, rtol 2e-4)."""
    import torch
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(0)

    def u(*shape):
        return torch.rand(*shape, device="cuda", generator=gen)

    def inputs(B, S, W):
        return (0.5 + 0.499 * u(B, S, W), 0.4 * u(B, S, W) - 0.2,
                0.4 * u(B, W) - 0.2)

    a, b, h0 = inputs(1, 2048, 4096)
    got, want = rglru_scan(a, b, h0), rglru_scan_plain(a, b, h0)
    if not all(torch.allclose(g, w, atol=2e-5, rtol=2e-4)
               for g, w in zip(got, want)):
        sys.exit("rglru_scan disagrees with its plain version")
    # once untimed: the first timing of a process loads the flush and
    # sleep kernels while its calls queue, and read 2-3x the time at S = 16
    cuda_ms(lambda: rglru_scan(a, b, h0))
    ms = {}
    for shape in RGLRU_TIMED:
        a, b, h0 = inputs(*shape)
        ms[str(list(shape))] = cuda_ms(lambda: rglru_scan(a, b, h0))
    return ms


TIMED = {"rglru_scan": time_rglru_scan}


def one(kernel, root):
    """Time ``root``'s ``kernel``; print {"checkout", "kernel", "ms"}."""
    sys.path.insert(0, f"{root}/src")      # before chip_smoke's own src
    print(json.dumps({"checkout": root, "kernel": kernel,
                      "ms": TIMED[kernel]()}), flush=True)


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        return one(sys.argv[2], sys.argv[3])
    if len(sys.argv) < 3 or sys.argv[1] not in TIMED:
        sys.exit(__doc__)
    kernel = sys.argv[1]
    for root in sys.argv[2:]:
        subprocess.run([sys.executable, __file__, "--one", kernel, root],
                       check=True, timeout=600)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
