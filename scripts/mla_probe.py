"""The MLA slice alone on the card: ``chip_smoke.py``'s phases 21-25.

Builds every kernel, prints ptxas's report of the flash kernels, then
runs "mla model" (deepseek-v3-671b at full width, 5 of its 61 layers,
bf16), "mla prefill", "mla flash", "mla serve", "mla main-path inputs"
and "mla agreement" as the full script does, and prints the seconds of
each.

    python3 scripts/mla_probe.py        # needs one CUDA card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("mla_probe: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi(), flush=True)
    seconds = {"build": _build.build_all()}
    cs.ptxas_report(_build)

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    cs.mla_phases(phase, torch.device("cuda"))
    cs.say("phase seconds", **{k.replace(" ", "_"): v
                               for k, v in seconds.items()})


if __name__ == "__main__":
    main()
