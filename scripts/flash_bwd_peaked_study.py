#!/usr/bin/env python3
"""The bf16 flash attention backward against chip_smoke.py's bf16 check
under a peaked softmax.

  python3 scripts/flash_bwd_peaked_study.py

For head dims 64, 80, 128 and MLA's (192, 128), q scaled by 1, 2, 4 and 8
(the larger the scale, the more each row's softmax sits on one key), 4
draws each of q, k, v, dO (1, 4, 512, hd) causal, it runs the forward
kernel with its lse and the bf16 backward kernels, and prints, per
gradient, the worst entry's error against the plain fp32 backward over
chip_smoke.py's bf16 limit (FLASH_BWD_TOLS: atol + rtol |x|; the check
passes up to 1), and the largest distance from an fp64 backward of the
same inputs (the kernel's o and lse) of the bf16 kernel, of the plain
version rounded to bf16, and of the fp32 CUDA-core kernel.  The limit's
atol assumes the two sides' fp32 sums within 1e-5 of each other; the
fp32 kernel's distance from fp64 shows how far a peaked softmax takes
them.  About 45 s on an H100 with the build.  Needs a card and nvcc;
imports nothing of JAX."""
import importlib
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _fp64_bwd(q, k, v, o, lse, g):
    """dq, dk, dv in fp64 from the forward's o and lse: causal, one KV head
    a query head."""
    import torch
    q, k, v, o, g = (t.double() for t in (q, k, v, o, g))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    n = q.shape[2]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    p = torch.where(mask, torch.exp(s - lse.double()[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (g * o).sum(-1, keepdim=True))
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale,
            torch.einsum("bhqk,bhqd->bhkd", p, g))


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    card = cs.phase_device()
    build.build_all(("flash_attention", "flash_attention_bwd"))
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    atol, rtol = cs.FLASH_BWD_TOLS["bfloat16"]
    for hd, hd_v in ((64, 64), (80, 80), (128, 128), (192, 128)):
        for scale in (1.0, 2.0, 4.0, 8.0):
            worst = {}
            for seed in range(4):
                gen = torch.Generator(device="cuda").manual_seed(seed)
                rn = lambda *sh: torch.randn(*sh, generator=gen,
                                             device="cuda")
                q = (rn(1, 4, 512, hd) * scale).bfloat16()
                k = rn(1, 4, 512, hd).bfloat16()
                v, g = (rn(1, 4, 512, hd_v).bfloat16() for _ in range(2))
                o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
                got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g)
                plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, g)
                f32 = fa.flash_attention_bwd_cuda(
                    q.float(), k.float(), v.float(), o.float(), lse,
                    g.float())
                exact = _fp64_bwd(q, k, v, o, lse, g)
                for name, a, b, c, e in zip(("dq", "dk", "dv"), got, plain,
                                            f32, exact):
                    a, b = a.float(), b.float()
                    w = worst.setdefault(name, [0.0] * 4)
                    for i, x in enumerate((
                            ((a - b).abs() / (atol + rtol * b.abs())).max(),
                            (a.double() - e).abs().max(),
                            (b.double() - e).abs().max(),
                            (c.double() - e).abs().max())):
                        w[i] = max(w[i], float(x))
            print(f"[peaked] hd {hd}/{hd_v}, q x {scale}: " + "; ".join(
                f"{n} worst err / limit {w[0]:.3g}, |bf16 kernel - fp64| "
                f"{w[1]:.3g}, |plain in bf16 - fp64| {w[2]:.3g}, |fp32 "
                f"kernel - fp64| {w[3]:.3g}" for n, w in worst.items())
                + f"; on {card}", flush=True)


if __name__ == "__main__":
    main()
