"""The spread of chip_smoke.py phase 40's gradient check, on the card.

Phase 40 holds one recurrent step of a freshly trained temporal upscaler
(`python -m hrt_tpu_torch.train_upscaler --temporal`) through K6 and its
backward against the plain warp route, the parameter gradients within
1e-4 of each tensor's largest entry.  This probe trains N nets anew at
the trainer's sizes (600 steps, 60 recurrent) and, for both of each
run's sequences, prints the check's reading (K6 against plain, the worst
tensor) and K6 against itself (the float atomics' run-to-run spread),
with cuDNN deterministic so that only the warp differs.

    python scripts/torch_recurrent_grad_probe.py [N]     (default 8)

It needs a CUDA device; on an H100 a net takes about 25 s.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from hrt_tpu_torch import train_upscaler as tu  # noqa: E402
from hrt_tpu_torch.kernels import build  # noqa: E402
from hrt_tpu_torch.models import upscaler  # noqa: E402


def grads(net, seq, plain: bool):
    net.zero_grad(set_to_none=True)
    with upscaler.fp32_convs():
        loss = tu.recurrent_loss(net, *seq, plain=plain)
        loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in net.parameters()]


def rel(ga, gb) -> list:
    """Each tensor's largest |a - b| over its largest |b|."""
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(ga, gb)]


def main() -> None:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    build.build()
    build.load()
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        for run in range(runs):
            tr = tu.main(["--device", "cuda", "--temporal", "--steps",
                          "600", "--recurrent-steps", "60", "--out",
                          os.path.join(tmp, "t.npz")])
            net = tr["net"]
            names = [n for n, _ in net.named_parameters()]
            for si, seq in enumerate(tr["seqs"]):
                lk, gk = grads(net, seq, False)
                lp, gp = grads(net, seq, True)
                _, gk2 = grads(net, seq, False)
                r = rel(gk, gp)
                i = max(range(len(r)), key=r.__getitem__)
                print(f"run {run} seq {si}: loss k6 {lk:.9f} plain "
                      f"{lp:.9f}; k6 vs plain {r[i]:.3g} ({names[i]}, max "
                      f"{float(gp[i].abs().max()):.3g}); k6 vs k6 "
                      f"{max(rel(gk, gk2)):.3g}; all "
                      f"{[f'{x:.2g}' for x in r]}", flush=True)


if __name__ == "__main__":
    main()
