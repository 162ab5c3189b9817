"""The MoE slice alone on the card: ``chip_smoke.py``'s phases 16-20.

Builds every kernel, then runs "moe model" (mixtral-8x22b at full width,
8 of its 56 layers, bf16), "moe prefill", "moe layer", "moe agreement",
"moe serve" and "moe main-path inputs" as the full script does, and
prints the seconds of each.

    python3 scripts/moe_probe.py        # needs one CUDA card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("moe_probe: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi(), flush=True)
    seconds = {"build": _build.build_all()}

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    cs.moe_phases(phase, torch.device("cuda"))
    cs.say("phase seconds", **{k.replace(" ", "_"): v
                               for k, v in seconds.items()})


if __name__ == "__main__":
    main()
