"""The port's training launcher (``repro_torch.launch.train``) on the CPU
against the reference's system tests (mirrors
``tests/test_system.py:13-35``): the loss decreases, a crash then a
resume is exact, a restore reaches the model's inference entries, and
the port resumes a checkpoint that the reference's launcher wrote."""
import shutil

import numpy as np
import pytest
import torch

from repro.launch import train as ref_train
from repro_torch.launch import train
from repro_torch.models import Model

SMOKE = ["--arch", "smollm-135m-smoke", "--batch", "4", "--seq", "64",
         "--log-every", "50"]


def _run(args, stats=None):
    return train.main(SMOKE + args + ["--device", "cpu"], stats=stats)


def test_training_loss_decreases():
    losses = _run(["--steps", "25", "--lr", "3e-3"])
    assert len(losses) == 25
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.05


def test_crash_resume_is_exact(tmp_path):
    """The reference's crash at step 9 and resume from the step-10
    checkpoint; the resumed losses equal the uninterrupted run's bit for
    bit (the reference's bar is 1e-6 on the last), and so do the crashed
    run's losses before the crash."""
    ck = str(tmp_path / "ck")
    ref = _run(["--steps", "14"])
    crashed = {}
    with pytest.raises(SystemExit) as exit_:
        _run(["--steps", "14", "--ckpt-dir", ck, "--ckpt-every", "5",
              "--fail-at", "9"], crashed)
    assert exit_.value.code == 42
    assert [l for _, l, _ in crashed["steps"]] == ref[:10]
    assert [s for s, _, _ in crashed["saves"]] == [5, 10]
    resumed_stats = {}
    resumed = _run(["--steps", "14", "--ckpt-dir", ck, "--ckpt-every", "5"],
                   resumed_stats)
    assert resumed_stats["start"] == 10
    assert resumed == ref[10:]
    assert resumed[-1] == pytest.approx(ref[-1], abs=1e-6)


def _prompt(cfg):
    tok = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 16))
    return {"tokens": torch.as_tensor(tok)}


def test_restore_reaches_the_models_inference(tmp_path):
    """A run that resumes installs the checkpoint in its model:
    ``prefill_logits`` after the restore equals the saved model's bit for
    bit, and differs from the freshly drawn parameters'."""
    ck = str(tmp_path / "ck")
    saved = {}
    _run(["--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3"], saved)
    restored = {}
    assert _run(["--steps", "6", "--ckpt-dir", ck], restored) == []
    assert restored["start"] == 6
    a, b = saved["model"], restored["model"]
    assert a is not b
    batch = _prompt(a.cfg)
    want = a.prefill_logits(batch)
    got = b.prefill_logits(batch)
    assert torch.equal(got, want)
    fresh = Model(a.cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert not torch.equal(fresh.prefill_logits(batch), want)
    assert all(p.requires_grad for p in b.parameters())


def test_resumes_the_references_checkpoint(tmp_path):
    """The reference's launcher crashes after step 4 with a checkpoint at
    step 5; the port and the reference resume from copies of that
    directory.  Their first resumed losses agree to 1e-2 absolute (the
    smoke config runs bf16; observed 4.1e-5)."""
    args = SMOKE + ["--steps", "7", "--ckpt-every", "5"]
    src = str(tmp_path / "ref")
    with pytest.raises(SystemExit) as exit_:
        ref_train.main(args + ["--ckpt-dir", src, "--fail-at", "4"])
    assert exit_.value.code == 42
    for name in ("a", "b"):
        shutil.copytree(src, str(tmp_path / name))
    stats = {}
    got = train.main(args + ["--ckpt-dir", str(tmp_path / "a"),
                             "--device", "cpu"], stats=stats)
    want = ref_train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert stats["start"] == 5 and len(got) == len(want) == 2
    assert abs(got[0] - want[0]) <= 1e-2


def test_launcher_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(SMOKE + ["--steps", "1"])
