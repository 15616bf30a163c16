"""The port's persistence: default save/load, step checkpoints, fit resume, the SIGTERM flush.

Held against the JAX package where both answer the same question (a
checkpointer's latest step and restored values, the missing-checkpoint
error, the preemption exit) and against the port's own uninterrupted run
where the port promises more: a ``TrainState`` restores bitwise, and ``fit``
resumed from a checkpoint ends in exactly (bitwise) the state of the same
steps run without the interruption. No tolerance anywhere: every comparison
is exact.
"""

import io
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.checkpoint import Checkpointer as JCheckpointer
from unionml_tpu.checkpoint import load_pytree, save_pytree
from unionml_tpu_torch.checkpoint import Checkpointer, default_load, default_save, extract_state, restore_state
from unionml_tpu_torch.models import BertConfig, MLPClassifier, create_train_state, fit, init_bert

REPO_ROOT = Path(__file__).resolve().parents[1]


def _state(seed: int = 0):
    torch.manual_seed(seed)
    model = MLPClassifier(8, hidden_sizes=(16,), num_classes=2, device="cpu")
    return create_train_state(model, learning_rate=1e-2, seed=seed)


def _data(n: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.normal(size=(n, 8)).astype(np.float32), "labels": rng.integers(0, 2, n).astype(np.int32)}


def _assert_states_equal(a, b):
    assert a.step == b.step and a.names == b.names
    for group in ("params", "mu", "nu"):
        for x, y in zip(getattr(a, group), getattr(b, group)):
            assert torch.equal(x, y), group


def test_tree_round_trip_matches_jax(tmp_path):
    tree = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3), "nested": {"b": np.zeros(3, np.float32)}}
    save_pytree({k: jnp.asarray(v) if not isinstance(v, dict) else v for k, v in tree.items()}, tmp_path / "j.ckpt")
    jrestored = load_pytree(tmp_path / "j.ckpt", target=tree)
    target = {"w": torch.zeros(2, 3), "nested": {"b": torch.ones(3)}}
    default_save({"w": torch.from_numpy(tree["w"]), "nested": {"b": torch.zeros(3)}}, {"lr": 0.1}, tmp_path / "t.pt")
    restored = default_load(tmp_path / "t.pt", init_fn=lambda hp: target)
    assert np.array_equal(restored["w"].numpy(), np.asarray(jrestored["w"]))
    assert np.array_equal(restored["nested"]["b"].numpy(), np.asarray(jrestored["nested"]["b"]))


@pytest.mark.parametrize("file_kind", ["path", "fileobj"])
def test_train_state_save_load_bitwise(tmp_path, file_kind):
    state = _state()
    fit(state, _data(), batch_size=16, num_steps=3, input_signature=("inputs",), log_every=100)
    target = tmp_path / "state.pt" if file_kind == "path" else io.BytesIO()
    default_save(state, {"seed": 1}, target)
    if file_kind == "fileobj":
        target.seek(0)
    seen = {}

    def init_fn(hp):
        seen.update(hp)
        return _state(seed=1)  # other weights: the load must overwrite them all

    loaded = default_load(target, init_fn=init_fn)
    assert seen == {"seed": 1}
    _assert_states_equal(loaded, state)
    payload = torch.load(tmp_path / "state.pt" if file_kind == "path" else io.BytesIO(target.getvalue()),
                         weights_only=True)  # loads without unpickling code
    assert payload["__unionml_tpu_torch_format__"] == "train_state"


def test_module_and_sklearn_round_trip(tmp_path):
    from sklearn.linear_model import LogisticRegression

    model = init_bert(BertConfig.tiny(dtype=torch.float32), seed=3, device="cpu")
    default_save(model, {"seed": 3}, tmp_path / "m.pt")
    loaded = default_load(tmp_path / "m.pt", init_fn=lambda hp: init_bert(BertConfig.tiny(dtype=torch.float32),
                                                                           seed=0, device="cpu"))
    for (name, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), name
    clf = LogisticRegression().fit(np.eye(4), [0, 1, 0, 1])
    default_save(clf, None, tmp_path / "clf.joblib")
    assert np.array_equal(default_load(tmp_path / "clf.joblib").coef_, clf.coef_)
    with pytest.raises(NotImplementedError, match="Model.saver"):
        default_save(object(), None, tmp_path / "x")


def test_checkpointer_steps_match_jax(tmp_path):
    jckpt, tckpt = JCheckpointer(tmp_path / "j", save_interval_steps=1), Checkpointer(tmp_path / "t")
    try:
        assert jckpt.latest_step() is None and tckpt.latest_step() is None
        for step in range(3):
            jckpt.save(step, {"w": jnp.ones((4,)) * (step + 1), "step": jnp.asarray(step)})
            tckpt.save(step, {"w": torch.ones(4) * (step + 1), "step": torch.tensor(step)})
        jckpt.flush()
        tckpt.flush()
        assert tckpt.latest_step() == jckpt.latest_step() == 2
        for step in (None, 1):
            want = jckpt.restore({"w": jnp.zeros((4,)), "step": jnp.asarray(0)}, step=step)
            got = tckpt.restore({"w": torch.zeros(4), "step": torch.tensor(0)}, step=step)
            assert np.array_equal(got["w"].numpy(), np.asarray(want["w"])) and int(got["step"]) == int(want["step"])
    finally:
        jckpt.close()
        tckpt.close()


def test_missing_checkpoint_raises_like_jax(tmp_path):
    for cls in (JCheckpointer, Checkpointer):
        ckpt = cls(tmp_path / cls.__module__)
        try:
            with pytest.raises(FileNotFoundError, match="No checkpoint"):
                ckpt.restore({"w": jnp.zeros(2)} if cls is JCheckpointer else {"w": torch.zeros(2)})
        finally:
            ckpt.close()


def test_interval_and_max_to_keep(tmp_path):
    ckpt = Checkpointer(tmp_path / "c", max_to_keep=2, save_interval_steps=3)
    try:
        saved = [step for step in range(1, 13) if ckpt.save(step, {"w": torch.full((2,), float(step))})]
        ckpt.flush()
        assert saved == [3, 6, 9, 12]
        assert sorted(int(p.name) for p in (tmp_path / "c").iterdir()) == [9, 12]
        assert not ckpt.save(12, {"w": torch.zeros(2)})  # already saved
    finally:
        ckpt.close()


def test_save_snapshots_before_returning(tmp_path):
    """The train step updates the state in place: a save must copy it before
    it returns, so the step after it cannot reach the checkpoint."""
    state = _state()
    ckpt = Checkpointer(tmp_path / "c")
    try:
        before = extract_state(state)
        ckpt.save(1, state)
        with torch.no_grad():
            for p in state.params:
                p.add_(1.0)
        ckpt.flush()
        restored = ckpt.restore(_state(seed=5))
        for name, p in zip(restored.names, restored.params):
            assert torch.equal(p, before["params"][name])
    finally:
        ckpt.close()


def test_restore_rejects_mismatched_parameters(tmp_path):
    ckpt = Checkpointer(tmp_path / "c")
    try:
        ckpt.save(1, _state())
        ckpt.flush()
        other = create_train_state(MLPClassifier(8, hidden_sizes=(16, 4), num_classes=2, device="cpu"))
        with pytest.raises(ValueError, match="do not match"):
            ckpt.restore(other)
    finally:
        ckpt.close()


def test_fit_resume_equals_uninterrupted_run(tmp_path):
    """4 steps, checkpoint, a fresh state resumed by fit for 4 more: bitwise
    the state of the same 4 + 4 steps without a checkpoint."""
    data = _data()
    kwargs = dict(batch_size=16, num_steps=4, input_signature=("inputs",), log_every=100)
    straight = _state()
    fit(straight, data, **kwargs)
    fit(straight, data, **kwargs)

    ckpt_dir = str(tmp_path / "fit")
    first = fit(_state(), data, checkpoint_dir=ckpt_dir, checkpoint_every=2, **kwargs)
    assert first.steps == 4
    probe = Checkpointer(ckpt_dir)
    assert probe.latest_step() == 4
    probe.close()
    resumed = fit(_state(seed=7), data, checkpoint_dir=ckpt_dir, checkpoint_every=2, **kwargs)
    assert resumed.steps == 8 and resumed.state.step == 8
    _assert_states_equal(resumed.state, straight)
    probe = Checkpointer(ckpt_dir)
    assert probe.latest_step() == 8
    probe.close()


def test_restore_state_tree_keeps_target_dtype_and_device():
    restored = restore_state({"a": torch.zeros(2, dtype=torch.float64), "n": 0}, {"a": torch.ones(2), "n": 5})
    assert restored["a"].dtype == torch.float64 and restored["n"] == 5


def test_sigterm_flushes_pending_saves(tmp_path):
    """Preemption, end to end in a subprocess: SIGTERM runs the handler, the
    pending background write lands, and the process exits with 143, as the
    JAX package's does."""
    script = textwrap.dedent(
        f"""
        import os, signal, sys
        sys.path.insert(0, {str(REPO_ROOT)!r})
        import torch
        from unionml_tpu_torch.checkpoint import Checkpointer, install_preemption_handler

        ckpt = Checkpointer({str(tmp_path / "preempt")!r})
        install_preemption_handler(ckpt)
        ckpt.save(7, {{"w": torch.ones((512, 512))}})  # the write runs in the background
        print("READY", flush=True)
        os.kill(os.getpid(), signal.SIGTERM)
        print("UNREACHABLE", flush=True)
        """
    )
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert "READY" in result.stdout and "UNREACHABLE" not in result.stdout
    assert result.returncode == 143, result.stderr
    ckpt = Checkpointer(tmp_path / "preempt")
    try:
        assert ckpt.latest_step() == 7
        assert torch.equal(ckpt.restore({"w": torch.zeros(512, 512)})["w"], torch.ones(512, 512))
    finally:
        ckpt.close()
