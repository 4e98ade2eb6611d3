"""The port's checkpoints and its train CLI.

Checkpoints (the JAX package's layout: ``step_<N>/{manifest.json,
arrays.npz}`` and an atomic ``LATEST``): a bf16 model and its AdamW
state round-trip exactly; a stray ``.tmp_step_*`` directory is never
read; ``CheckpointManager`` keeps the last 3 steps and snapshots the
tensors before its thread starts; a restore puts every tensor on the
requested device.

The train CLI on the CPU (``--device cpu``, reduced qwen2-0.5b) keeps
the contracts of the JAX package's ``tests/test_system.py``: 25 steps at
batch 4, seq 64 lower the mean of the last 5 losses below the first 5's
by more than 0.1; 10 steps with a checkpoint every 5, then a restart to
16, run 6 steps whose last loss is below the first run's first.
Without a device and without CUDA it raises.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one CPU thread for the test: the suite runs several
    workers at once, and one thread per core in each oversubscribes the
    cores (the train CLI's 25 tiny steps took 75 s that way, 1 s
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(dtype="bfloat16"):
    cfg = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                              dtype=dtype)
    model = get_api(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(model)
    for n, m in opt.mu.items():
        m.normal_(generator=torch.Generator().manual_seed(len(n)))
    opt.step += 7
    return cfg, model, opt


def test_bf16_round_trip_is_exact(tmp_path):
    cfg, model, opt = _model()
    assert next(model.parameters()).dtype == torch.bfloat16
    save_checkpoint(tmp_path, 7, {"params": model, "opt": opt},
                    extra={"step": 7, "data": {"seed": 0, "step": 7}})
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert "params/blocks.0.attn.wq" in manifest["keys"]
    assert "opt/mu/blocks.0.attn.wq" in manifest["keys"]
    with np.load(tmp_path / "step_7" / "arrays.npz") as data:
        assert data["params/blocks.0.attn.wq"].dtype == np.float32
    skeleton, _ = abstract_params(cfg)
    (got, extra) = load_checkpoint(
        tmp_path, {"params": skeleton, "opt": adamw_init(skeleton)},
        device="cpu")
    assert extra == {"step": 7, "data": {"seed": 0, "step": 7}}
    assert got["params"] is skeleton
    want = model.state_dict()
    for name, t in got["params"].state_dict().items():
        assert t.dtype == want[name].dtype and t.device.type == "cpu"
        assert torch.equal(t, want[name]), name
    for name in opt.mu:
        assert torch.equal(got["opt"].mu[name], opt.mu[name])
        assert torch.equal(got["opt"].nu[name], opt.nu[name])
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7


def test_stray_tmp_directory_is_ignored(tmp_path):
    _, model, opt = _model()
    stray = tmp_path / ".tmp_step_9_123"
    stray.mkdir()
    (stray / "arrays.npz").write_bytes(b"not an archive")
    assert latest_step(tmp_path) is None
    save_checkpoint(tmp_path, 3, {"opt": opt})
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save_async(4, {"opt": opt})
    mgr.wait()
    assert latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_4"]
    got, _ = load_checkpoint(tmp_path, {"opt": adamw_init(model)},
                             device="cpu")
    assert int(got["opt"].step) == 7


def test_manager_keeps_three(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    for step in range(1, 6):
        mgr.save_async(step, {"x": torch.full((3,), float(step))},
                       extra={"step": step})
    mgr.wait()
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_3", "step_4", "step_5"]
    assert latest_step(tmp_path / "ck") == 5
    for step in (3, 4, 5):
        got, extra = load_checkpoint(tmp_path / "ck", {"x": torch.zeros(3)},
                                     step=step, device="cpu")
        assert extra["step"] == step and torch.equal(
            got["x"], torch.full((3,), float(step)))


def test_save_async_snapshots_before_its_thread(tmp_path, monkeypatch):
    """The tensors are copied to host memory in ``save_async`` itself:
    the thread, started only after the caller has changed them in place,
    still writes the values of the call."""
    import threading
    started = []

    class Deferred(threading.Thread):
        def start(self):
            started.append(self)

    monkeypatch.setattr(threading, "Thread", Deferred)
    x = torch.arange(4.0)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(1, {"x": x})
    x.add_(100.0)                   # the train loop's next in-place step
    monkeypatch.undo()
    threading.Thread.start(started[0])
    mgr.wait()
    got, _ = load_checkpoint(tmp_path, {"x": torch.zeros(4)}, device="cpu")
    assert torch.equal(got["x"], torch.arange(4.0))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_restore_places_tensors_on_the_device(tmp_path, device):
    cfg, model, opt = _model("float32")
    save_checkpoint(tmp_path, 1, {"params": model, "opt": opt})
    skeleton, _ = abstract_params(cfg)
    got, _ = load_checkpoint(tmp_path, {"params": skeleton,
                                        "opt": adamw_init(skeleton)},
                             device=device)
    tensors = [*got["params"].parameters(), *got["opt"].mu.values(),
               *got["opt"].nu.values(), got["opt"].step]
    assert all(t.device.type == device for t in tensors)


# ----------------------------------------------------------------------
# The train CLI
# ----------------------------------------------------------------------
ARGS = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--batch",
        "4", "--seq", "64"]


def test_train_loss_decreases(tmp_path):
    out = main(ARGS + ["--steps", "25", "--ckpt-dir", str(tmp_path / "ck")])
    losses = out["losses"]
    assert len(losses) == 25 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert latest_step(tmp_path / "ck") == 25


def test_train_restart_resumes(tmp_path):
    """Simulated failure: run 10 steps, 'crash', restart to 16: the
    resumed run continues from the checkpoint, not from scratch."""
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5"]
    first = main(ARGS + ["--steps", "10"] + ck)
    second = main(ARGS + ["--steps", "16"] + ck)
    assert len(second["losses"]) == 6
    assert second["losses"][-1] < first["losses"][0]


def test_train_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])
