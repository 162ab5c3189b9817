"""The encoder-decoder and VLM slice alone on the card: ``chip_smoke.py``'s
phases 34-41.

Builds every kernel, prints ptxas's report of the flash kernels, then runs
the encoder-decoder phases on whisper-base, uncut ("encdec model",
"encdec prefill", "encdec flash", "encdec agreement", "encdec serve"),
and the VLM phases on paligemma-3b, uncut ("vlm model", "vlm prefill",
"vlm flash", "vlm agreement", "vlm serve"), as the full script does, and
prints the seconds of each.

    python3 scripts/encdec_probe.py        # needs one CUDA card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("encdec_probe: needs a CUDA card")
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

    dev = torch.device("cuda")
    cs.encdec_phases(phase, dev)
    cs.vlm_phases(phase, dev)
    cs.say("phase seconds", **{k.replace(" ", "_"): v
                               for k, v in seconds.items()})


if __name__ == "__main__":
    main()
