"""Time the flash kernel of several checkouts on one card, in turns.

    python scripts/flash_ab.py build/parent . . build/parent

Each ROOT (a checkout: its ``src/repro_torch``, its kernels built under
``ROOT/build/kernels``) runs in a process of its own, in the order given,
and times its ``flash_attention`` by CUDA events (``chip_smoke.timed_ms``,
``REPS`` calls after a warm-up) on the shapes of ``SHAPES``: the script's
fixed 32k cases, the lm prefill's call, MLA's (192, 128) call and the
float32 case.  Inputs
are drawn from a seeded generator on the card, the same in every
process.  Prints one JSON line a run and, last, each shape's ms by root.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# name: (B, S, H, KV, d, dv, dtype, window, scale)
SHAPES = {"32k bf16 causal": (1, 32768, 12, 2, 128, 128, "bfloat16", 0,
                              None),
          "32k bf16 window 4096": (1, 32768, 12, 2, 128, 128, "bfloat16",
                                   4096, None),
          "lm prefill call": (2, 4096, 12, 2, 128, 128, "bfloat16", 0, None),
          "mla call": (1, 8192, 128, 128, 192, 128, "bfloat16", 0,
                       192 ** -0.5),
          "4k f32 d64": (2, 4096, 9, 3, 64, 64, "float32", 0, None)}
REPS = 10


def run_one(root: Path) -> dict:
    sys.path[:0] = [str(root.resolve() / "src"),
                    str(Path(__file__).resolve().parents[1])]
    import torch
    from chip_smoke import timed_ms
    from repro_torch.kernels import attention
    out = {}
    for name, (B, S, H, KV, d, dv, dt, window, scale) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(5)
        q, k, v = (torch.randn((B, S, h, w), generator=g, device="cuda")
                   .to(getattr(torch, dt))
                   for h, w in ((H, d), (KV, d), (KV, dv)))
        out[name] = timed_ms(lambda: attention.flash_attention(
            q, k, v, causal=True, window=window, scale=scale), REPS)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(Path(argv[1]))), flush=True)
        return
    by_root: dict = {}
    for i, root in enumerate(argv):
        res = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, check=True)
        times = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "root": root, "ms": times}), flush=True)
        for name, ms in times.items():
            by_root.setdefault(name, {}).setdefault(root, []).append(ms)
    print(json.dumps(by_root), flush=True)


if __name__ == "__main__":
    main()
