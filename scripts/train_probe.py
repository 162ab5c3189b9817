"""The training slice alone on the card: ``chip_smoke.py``'s phases 42-48.

Builds every kernel, prints the flash backward's nvcc seconds and ptxas
report, then runs "flash bwd agreement", "flash bwd time", "train smoke",
"train model", "train" (qwen2-1.5b at full width, three steps of 8 x
4,096 tokens), "train compressed", "train launcher" and "train
checkpoint" as the full script does, prints the
seconds of each and the backward kernels' entries of the
``kernels`` line.

    python3 scripts/train_probe.py        # needs one CUDA card
"""
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_probe: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi(), flush=True)
    seconds = {"build": _build.build_all()}
    cs.say("build", nvcc_s=json.dumps(dict(sorted(
        _build.BUILD_SECONDS.items()))))
    cs.say("ptxas flash_attn_bwd", report=json.dumps(
        [ln.strip() for ln in _build.build_log("flash_attn_bwd").splitlines()
         if re.search(r"entry function|registers|spill", ln)]))

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    entries, _ = cs.train_phases(phase, torch.device("cuda"))
    cs.say("phase seconds", **{k.replace(" ", "_"): v
                               for k, v in seconds.items()})
    print(json.dumps({"kernels": entries}), flush=True)


if __name__ == "__main__":
    main()
