"""The training launcher and checkpoints alone on the card:
``chip_smoke.py``'s phases 47-48.

Builds every kernel, then runs "train launcher" (``launch/train.py`` at
smollm-135m, full width: an uninterrupted run, a run that fails after
step 9 and its resume from step 10, with ``--select-data``) and "train
checkpoint" on a freshly drawn qwen2-1.5b train state (bf16 parameters,
zero float32 moments: the same bytes as phase 45's state), and prints
the seconds of each.

    python3 scripts/launcher_probe.py        # needs one CUDA card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("launcher_probe: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.training.step import init_train_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi(), flush=True)
    seconds = {"build": _build.build_all()}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cs.phase_train_launcher(dev)
    seconds["train launcher"] = time.perf_counter() - t0
    model = cs.train_model(dev)
    state = init_train_state(model)
    t0 = time.perf_counter()
    cs.phase_train_checkpoint(model, state["opt"])
    seconds["train checkpoint"] = time.perf_counter() - t0
    cs.say("phase seconds", **{k.replace(" ", "_"): v
                               for k, v in seconds.items()})


if __name__ == "__main__":
    main()
