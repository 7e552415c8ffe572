"""The port's entry points over every rank, as the reference's run on
every device of their host: ``repro_torch.launch.serve`` and
``repro_torch.launch.train`` under ``python -m torch.distributed.run
--standalone --nproc-per-node=2 ... --device cpu`` (two ``gloo`` ranks on
a ``(2,)`` ``("data",)`` DeviceMesh, the data-parallel policy), each held
to the same CLI run as one process; and the calibration CLI
``scripts/torch/autotune.py`` with ``--check``.

The reference's own ``serve`` / ``train`` fail under jax 0.9.0
(``tests/test_system.py``), so the sharded runs are held to the port's
one-process runs, which ``test_torch_serve_graph.py`` and
``test_torch_train_graph.py`` hold to the reference.  Every command of
the module starts at once in a module fixture.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from repro_torch.core import tuning

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
AUTOTUNE = os.path.join(ROOT, "scripts", "torch", "autotune.py")
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node=2"]
SERVE = ["-m", "repro_torch.launch.serve", "--arch", "minitron-4b",
         "--smoke", "--device", "cpu", "--requests", "6", "--batch-size",
         "3", "--decode-steps", "8", "--topk", "10"]
TRAIN = ["-m", "repro_torch.launch.train", "--arch", "moonshot-v1-16b-a3b",
         "--smoke", "--device", "cpu", "--steps", "3"]
CAL = ["--device", "cpu", "--tile-n", "512", "--batch", "8", "--reps", "1"]
# the two-rank run's losses against the one-process run's: the first
# (the same forward) equal as printed; after AdamW steps within 1e-3
# relative.  The smoke model is bfloat16: each rank's gradient of an
# FSDP-sharded weight is a bfloat16 partial sum of its rows, rounded
# otherwise than the whole batch's (1.8e-4 at the third step; in float32
# the gradients agree to 1.2e-6, test_torch_ranks.py's
# test_data_policy_gradients)
LOSS_REL = 1e-3
TIMEOUT_S = 300
# the JAX package's names -> the port's (as test_torch_calibrate.py)
NAMES = {"xla": "torch", "pallas": "cuda", "xla_topk": "torch_topk",
         "pallas_interpret_penalty": "cuda_plain_penalty"}

_REFERENCE = r"""
import json, sys
from repro.engine import planner
p = planner.calibrate(tile_n=512, batch=8, reps=1)
d = p.to_dict()
print("REF_KEYS " + json.dumps({
    "doc": sorted(d), "constants": sorted(d["constants"]),
    "probe_ns": sorted(d["probe_ns"]),
    "sweeps": {k: sorted(v) for k, v in d["sweeps"].items()}}))
"""


def _env(tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    # no profile of the user's cache: each process resolves the seeds
    env[tuning.PROFILE_DIR_ENV] = str(tmp / "profiles")
    env.pop("XLA_FLAGS", None)
    return env


def _start(cmd, env):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs: dict) -> dict:
    out = {}
    for name, p in procs.items():
        try:
            text = p.communicate(timeout=TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        out[name] = (p.returncode, text)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    env = _env(tmp)
    ref_env = dict(env, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu")
    py = [sys.executable]
    procs = {
        "serve_one": _start(py + SERVE, env),
        "serve_two": _start(TORCHRUN + SERVE, env),
        "train_one": _start(py + TRAIN + ["--ckpt-dir", str(tmp / "one")],
                            env),
        "train_two": _start(TORCHRUN + TRAIN + ["--ckpt-dir",
                                                str(tmp / "two")], env),
        "autotune": _start(py + [AUTOTUNE] + CAL + [
            "--out", str(tmp / "profile.json"), "--check"], env),
        "reference": _start(py + ["-c", _REFERENCE], ref_env),
    }
    out = _finish(procs)
    ckpts = sorted(os.listdir(tmp / "two"))
    # a resume of the two-rank run's checkpoint on one process
    out.update(_finish({"resume": _start(py + TRAIN[:-1] + [
        "5", "--ckpt-dir", str(tmp / "two")], env)}))
    return {"out": out, "tmp": tmp, "ckpts": ckpts}


def _ok(runs, name) -> str:
    rc, text = runs["out"][name]
    assert rc == 0, f"{name} exited {rc}:\n{text[-4000:]}"
    return text


def _lines(text: str, tag: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(tag)]


def _summary(text: str) -> list:
    """The serve's printed summary with its timings cut: requests,
    batches, device and padding waste; the decode route; the length
    accounting."""
    out = []
    for ln in _lines(text, "[serve] "):
        if "torchrun:" in ln:
            continue
        out.append(re.sub(r"; prefill .*$", "", ln))
    return out


def test_serve_under_torchrun_names_the_data_mesh(runs):
    """Two ranks serve under the data policy on the (2,) ``data`` mesh;
    rank 0 alone prints (one summary, one mesh line)."""
    text = _ok(runs, "serve_two")
    assert _lines(text, "[serve] torchrun:") == [
        "[serve] torchrun: 2 rank(s), the data policy on a DeviceMesh (2,) "
        "('data',) on cpu over gloo"]
    assert len(_lines(text, "[serve] 6 requests")) == 1


def test_serve_summary_equals_the_one_process_run(runs):
    """Requests, batches, padding waste, the decode route and the length
    accounting as the one-process CLI prints them."""
    one, two = _ok(runs, "serve_one"), _ok(runs, "serve_two")
    assert "torchrun" not in one
    want = _summary(one)
    assert len(want) == 3 and want[0].startswith(
        "[serve] 6 requests in 2 batches on cpu; mean padding waste")
    assert _summary(two) == want


def _losses(text: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^\[train\] step +(\d+) loss +(\S+)", text, re.M)}


def test_train_under_torchrun_matches_the_one_process_run(runs):
    """Three steps of the smoke moonshot on two ranks: the data mesh
    named once, the printed losses (steps 0 and 2) finite, the first
    equal to the one-process run's and the last within ``LOSS_REL``."""
    one, two = _ok(runs, "train_one"), _ok(runs, "train_two")
    assert _lines(two, "[train] torchrun:") == [
        "[train] torchrun: 2 rank(s), the data policy on a DeviceMesh (2,) "
        "('data',) on cpu over gloo"]
    a, b = _losses(one), _losses(two)
    assert set(a) == set(b) == {0, 2}
    assert all(v == v and abs(v) < float("inf") for v in b.values())
    assert a[0] == b[0]
    assert abs(a[2] - b[2]) <= LOSS_REL * abs(a[2]), (a, b)


def test_train_under_torchrun_writes_one_checkpoint_and_resumes(runs):
    """Rank 0 alone writes: one checkpoint, at the last step; a run on
    one process resumes from it and goes on counting steps."""
    _ok(runs, "train_two")
    assert runs["ckpts"] == ["step_00000003"]
    text = _ok(runs, "resume")
    assert "[train] resumed from step 3 -> starting at 3" in text
    assert set(_losses(text)) == {4}
    assert sorted(os.listdir(runs["tmp"] / "two")) == [
        "step_00000003", "step_00000005"]


def test_autotune_check_passes_on_a_fresh_profile(runs):
    """``scripts/torch/autotune.py ... --check`` exits 0, naming this
    machine's fingerprint and the file it wrote."""
    text = _ok(runs, "autotune")
    assert f"[autotune] fingerprint   {tuning.device_fingerprint()}" in text
    assert f"[autotune] wrote {runs['tmp'] / 'profile.json'}" in text
    assert "[autotune] check OK" in text


def test_autotune_profile_keys_equal_the_reference(runs):
    """The written profile's keys are the reference's ``calibrate``'s at
    the same arguments under the port's names (as
    ``test_torch_calibrate.py`` compares them; the reference runs its
    function, not its CLI, which would write into the user's cache)."""
    text = _ok(runs, "reference")
    ref = json.loads(text.split("REF_KEYS ", 1)[1].splitlines()[0])
    got = json.loads((runs["tmp"] / "profile.json").read_text())
    # the port keeps the link constants apart (``links``), where the
    # reference has them among its constants
    assert sorted(set(got) - {"links"}) == ref["doc"]
    assert sorted(got["probe_ns"]) == sorted(_ported(k)
                                             for k in ref["probe_ns"])
    assert {k: sorted(v) for k, v in got["sweeps"].items()} == \
        ref["sweeps"]
    ported = {NAMES.get(k, k) for k in ref["constants"]} - {
        "collective_alpha", "collective_per_byte", "dcn_alpha",
        "dcn_per_byte"}
    assert sorted(ported | {"torch_card"}) == sorted(got["constants"])


def _ported(name: str) -> str:
    head, _, rest = name.partition(".")
    return ".".join([NAMES.get(head, head)] + ([rest] if rest else []))


def _corrupt(doc: dict, how: str):
    if how == "truncated":
        return json.dumps(doc)[:-40]
    doc = json.loads(json.dumps(doc))
    if how == "schema":
        doc["schema"] = "repro_torch.tuning.profile/v0"
    elif how == "fingerprint":
        doc["fingerprint"] = "cuda/another-card/torch-0"
    elif how == "constant":
        doc["constants"]["torch"] *= 2
    return json.dumps(doc)


def _autotune_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("_autotune", AUTOTUNE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("how", ["truncated", "schema", "fingerprint",
                                 "constant"])
def test_autotune_check_fails_on_a_corrupted_profile(runs, how, capsys):
    """A corrupted copy of the written profile (cut short, another
    schema, another machine's fingerprint, a constant changed) fails
    ``--check``'s test with 1, naming why."""
    src = runs["tmp"] / "profile.json"
    prof = tuning.load(src)
    bad = runs["tmp"] / f"bad_{how}.json"
    bad.write_text(_corrupt(json.loads(src.read_text()), how))
    assert _autotune_module().check(bad, prof) == 1
    assert "CHECK FAILED" in capsys.readouterr().err
    assert _autotune_module().check(src, prof) == 0


def test_autotune_cli_exits_1_when_the_written_file_is_corrupted(
        tmp_path, monkeypatch, capsys):
    """The CLI itself: a profile corrupted as it is written makes
    ``--check`` exit 1."""
    monkeypatch.setenv(tuning.PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    real = tuning.save

    def save(profile, path=None):
        p = real(profile, path)
        p.write_text(p.read_text()[:-40])
        return p
    monkeypatch.setattr(tuning, "save", save)
    out = tmp_path / "p.json"
    try:
        rc = _autotune_module().main(CAL + ["--no-sweeps", "--out",
                                            str(out), "--check"])
    finally:
        tuning.set_active(None)
    assert rc == 1 and out.is_file()
    assert "CHECK FAILED: reload rejected" in capsys.readouterr().err


def test_one_process_runs_name_no_mesh(runs):
    """Outside ``torchrun`` both CLIs run one process, as before."""
    for name in ("serve_one", "train_one"):
        assert "torchrun" not in _ok(runs, name)
    assert sorted(os.listdir(runs["tmp"] / "one")) == ["step_00000003"]
