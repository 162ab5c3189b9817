"""The SSM slice alone on the card: ``chip_smoke.py``'s phases 26-33.

Builds every kernel, then runs the SSM phases on mamba2-1.3b, uncut
("ssm model", "ssm prefill", "ssm scan", "ssm agreement", "ssm serve"),
and the hybrid phases on jamba-1.5-large-398b at full width, one period
cut to 4 sublayers ("hybrid model", "hybrid prefill", "hybrid flash",
"hybrid serve", "hybrid agreement"), as the full script does, and prints
the seconds of each.

    python3 scripts/ssm_probe.py        # needs one CUDA card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssm_probe: needs a CUDA card")
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

    dev = torch.device("cuda")
    cs.ssm_phases(phase, dev)
    cs.hybrid_phases(phase, dev)
    cs.say("phase seconds", **{k.replace(" ", "_"): v
                               for k, v in seconds.items()})


if __name__ == "__main__":
    main()
