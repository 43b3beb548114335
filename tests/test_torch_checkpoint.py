"""Checkpoint and exact resume in the PyTorch port, and across packages.

The port's ``checkpoint/`` writes and reads the JAX package's on-disk
format (``ckpt-<seq>/{state.pkl, manifest.json}``, a pickle of numpy and
Python values), so:

* (a) a port fit killed mid-epoch and resumed in a fresh Module ends bit
  for bit where its own uninterrupted fit ends — parameters, Adam states,
  update counts, the training step's key chain — with Dropout on;
* (b) a JAX fit killed at (1, 3) commits a checkpoint that the port
  resumes with ``fit(resume=dir)``, ending within rtol 1e-5 / atol 1e-6
  of the JAX uninterrupted fit, its Dropout masks after the resume bit
  for bit the JAX run's;
* (c) the reverse: the port's commit resumes in the JAX package;
* (d) the manager's contracts (atomic commit and retention, async
  commits, an empty directory, the ``MXNET_CKPT_*`` environment, the
  telemetry, the fallback past a damaged newest commit, quarantine, a
  retried write or device-to-host copy), one parametrised test;
* (e) a snapshot is not torn by the updates that run while the writer is
  held back.

The model is the small MLP with ``Dropout(0.3)`` of tests/test_checkpoint.py
(Adam with a ``FactorScheduler``, 10 batches of 4); the JAX fits run once
for the module (module-scoped fixtures).
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch.checkpoint import state as tstate

BATCH = 4
N_BATCHES = 10
CLASSES = 3
FEATS = 6
RTOL, ATOL = 1e-5, 1e-6
KEEP = 0.7


def _mlp(pkg, dropout=0.3):
    data = pkg.sym.var("data")
    fc = pkg.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    act = pkg.sym.Activation(fc, act_type="relu")
    if dropout:
        act = pkg.sym.Dropout(act, p=dropout)
    fc2 = pkg.sym.FullyConnected(act, num_hidden=CLASSES, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _data():
    rs = np.random.RandomState(0)
    X = rs.rand(N_BATCHES * BATCH, FEATS).astype(np.float32)
    y = rs.randint(0, CLASSES, (N_BATCHES * BATCH,)).astype(np.float32)
    return X, y


def _init_args(pkg):
    rs = np.random.RandomState(1)
    vals = {"fc1_weight": rs.randn(8, FEATS).astype(np.float32) * 0.1,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rs.randn(CLASSES, 8).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(CLASSES, np.float32)}
    ctx = pkg.cpu()
    return {k: pkg.nd.array(v, ctx=ctx) for k, v in vals.items()}


class _Kill(Exception):
    """A kill at a batch boundary: the module is abandoned."""


def _chain(pkg, mod):
    """The training step's key chain after a batch, as numpy."""
    if pkg is mx:
        return np.asarray(mod._exec_group.rng_chain())
    return np.array(mod._step_key, dtype=np.uint32)


def _run(pkg, kill_at=None, ckpt=None, resume=False, seed=7,
         optimizer="adam", every=2, num_epoch=2, shuffle=False):
    """One fit; returns (params, {(epoch, nbatch): chain key after it},
    module). ``kill_at`` raises from that batch's end callback, before
    its checkpoint tick."""
    X, y = _data()
    pkg.random.seed(seed)
    it = pkg.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=shuffle)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    sched = pkg.lr_scheduler.FactorScheduler(step=5, factor=0.5)
    chains = {}

    def cb(p):
        chains[(p.epoch, p.nbatch)] = _chain(pkg, mod)
        if kill_at is not None and (p.epoch, p.nbatch) == kill_at:
            raise _Kill()

    mgr = pkg.checkpoint.CheckpointManager(ckpt, every_n_batches=every) \
        if isinstance(ckpt, str) else ckpt
    opt_params = {"learning_rate": 0.05, "lr_scheduler": sched}
    if optimizer == "sgd":
        opt_params["momentum"] = 0.9
    try:
        mod.fit(it, num_epoch=num_epoch, batch_end_callback=cb,
                arg_params=_init_args(pkg), optimizer=optimizer,
                optimizer_params=opt_params, checkpoint=mgr, resume=resume)
    except _Kill:
        pass
    finally:
        if mgr is not None:
            mgr.close()
    if pkg is mx:
        mod._sync_params_from_devices()
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}, chains, mod


def _port_states(mod):
    """{name: [state arrays]} of the port's updater."""
    out = {}
    for i, st in mod._updater.states.items():
        leaves = st if isinstance(st, tuple) else (st,)
        out[mod._param_names[i]] = [s.asnumpy() for s in leaves]
    return out


def _jax_states(mod):
    return {k: [np.asarray(l) for l in jax.tree.leaves(v)]
            for k, v in mod._exec_group.export_fused_states().items()}


def _latest_cursor(d):
    seq, path = mxt.checkpoint.latest_checkpoint(d)
    with open(os.path.join(path, "manifest.json")) as f:
        c = json.load(f)["cursor"]
    return c["epoch"], c["nbatch"]


def _dropout_index(sym):
    return next(i for i, n in enumerate(sym._topo_nodes())
                if not n.is_variable and n.op == "Dropout")


def _jax_mask(chain_before, idx):
    """The JAX package's Dropout mask of the batch whose step starts from
    the chain key ``chain_before`` (the fused step splits the chain and
    folds the node index into the second half)."""
    fwd = jax.random.split(jax.numpy.asarray(chain_before))[1]
    rng = jax.random.fold_in(fwd, idx)
    return np.asarray(jax.random.bernoulli(rng, KEEP, (BATCH, 8)))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's uninterrupted fit and a fit killed at (1, 3) with
    a checkpoint every 2 batches."""
    d = str(tmp_path_factory.mktemp("jaxck") / "ck")
    full = _run(mx)
    _run(mx, kill_at=(1, 3), ckpt=d)
    return {"full": full, "dir": d}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's uninterrupted fit and a fit killed at (1, 3)."""
    d = str(tmp_path_factory.mktemp("portck") / "ck")
    full = _run(mxt)
    killed = _run(mxt, kill_at=(1, 3), ckpt=d)
    return {"full": full, "killed": killed, "dir": d}


# ----------------------------------------------------------- (a) exact
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_port_kill_resume_bit_for_bit(tmp_path, port_runs, optimizer):
    """Killed at (1, 3) and resumed under another seed, the port's fit
    ends bit for bit on its uninterrupted fit: parameters, optimizer
    states, counts, the key chain of every resumed batch, the cursor."""
    if optimizer == "adam":
        pa, ca, ma = port_runs["full"]
        d = port_runs["dir"]
        assert max(port_runs["killed"][1]) == (1, 3)
    else:
        pa, ca, ma = _run(mxt, optimizer="sgd")
        d = str(tmp_path / "ck")
        _run(mxt, optimizer="sgd", kill_at=(1, 3), ckpt=d)
    assert _latest_cursor(d) == (1, 2)
    pc, cc, mc = _run(mxt, resume=d, seed=999,
                      optimizer=optimizer)
    assert min(cc) == (1, 2)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pc[k], err_msg=k)
    sa, sc = _port_states(ma), _port_states(mc)
    assert sa.keys() == sc.keys()
    for k in sa:
        for x, z in zip(sa[k], sc[k]):
            np.testing.assert_array_equal(x, z, err_msg=k)
    assert mc._opt_counts() == ma._opt_counts()
    for key, chain in cc.items():
        np.testing.assert_array_equal(chain, ca[key], err_msg=str(key))


def test_port_resume_with_shuffle_sees_the_same_batches(tmp_path):
    """The port's NDArrayIter shuffles once, from its own
    ``RandomState(shuffle_seed)``, never from ``np.random``: a resumed
    fit's fresh iterator yields the killed run's order."""
    pa, _, _ = _run(mxt, shuffle=True, optimizer="sgd")
    d = str(tmp_path / "ck")
    _run(mxt, shuffle=True, optimizer="sgd", kill_at=(0, 6), ckpt=d)
    pc, _, _ = _run(mxt, shuffle=True, optimizer="sgd", resume=d, seed=3)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pc[k], err_msg=k)


def test_payload_holds_numpy_and_python_values_only(port_runs):
    """The committed payload is the JAX package's: numpy arrays, ints,
    dicts and tuples, staged canonical states, the chain as uint32[2]."""
    _, path = mxt.checkpoint.latest_checkpoint(port_runs["dir"])
    with open(os.path.join(path, "state.pkl"), "rb") as f:
        payload = tstate.read_payload(f)

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        else:
            assert not isinstance(v, torch.Tensor)
            assert v is None or isinstance(
                v, (np.ndarray, int, float, str, np.generic)), type(v)
    walk(payload)
    assert payload["version"] == 1 and payload["opt"]["mode"] == "staged"
    assert payload["opt"]["class"] == "Adam"
    mean, var = payload["device"]["opt_states"]["fc1_weight"]
    assert mean.shape == var.shape == (8, FEATS)
    chain = payload["rng"]["device_chain"]
    assert chain.dtype == np.uint32 and chain.shape == (2,)


# ------------------------------------------------------ (b), (c) across
def test_jax_commit_resumes_in_the_port(jax_runs, monkeypatch):
    """A JAX fit killed at (1, 3) resumes in the port: it ends within
    rtol 1e-5 / atol 1e-6 of the JAX uninterrupted fit, with the same
    update counts, and every Dropout mask the port draws after the resume
    is the JAX run's bit for bit."""
    pj, cj, mj = jax_runs["full"]
    assert _latest_cursor(jax_runs["dir"]) == (1, 2)
    masks = []
    op = mxt.ops.registry.get_op("Dropout")
    plain = op.forward

    def spy(attrs, inputs, aux, is_train, rng):
        outs, new_aux = plain(attrs, inputs, aux, is_train, rng)
        if is_train:
            masks.append(outs[1].detach().numpy() != 0)
        return outs, new_aux
    monkeypatch.setattr(op, "forward", spy)
    pt, ct, mt = _run(mxt, resume=jax_runs["dir"], seed=999)
    monkeypatch.setattr(op, "forward", plain)
    order = sorted(ct)
    assert order[0] == (1, 2) and len(masks) == len(order)
    idx = _dropout_index(_mlp(mx))
    for (e, n), mask in zip(order, masks):
        before = cj[(e, n - 1)]
        np.testing.assert_array_equal(mask, _jax_mask(before, idx),
                                      err_msg=str((e, n)))
        np.testing.assert_array_equal(ct[(e, n)], cj[(e, n)])
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    sj = _jax_states(mj)
    for k, leaves in _port_states(mt).items():
        for x, z in zip(leaves, sj[k]):
            np.testing.assert_allclose(x, z, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert mt._optimizer.num_update == mj._optimizer.num_update


def test_port_commit_resumes_in_jax(jax_runs, port_runs):
    """The reverse: the port's commit at (1, 2) resumes in the JAX
    package and ends within the same tolerance of its uninterrupted fit,
    with the same key chain."""
    pj, cj, mj = jax_runs["full"]
    pr, cr, mr = _run(mx, resume=port_runs["dir"], seed=999)
    assert min(cr) == (1, 2)
    for key, chain in cr.items():
        np.testing.assert_array_equal(chain, cj[key], err_msg=str(key))
    for k in pj:
        np.testing.assert_allclose(pr[k], pj[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert mr._optimizer.num_update == mj._optimizer.num_update


# ---------------------------------------------------- (d) the manager
def _tiny_module():
    X, y = _data()
    it = mxt.io.NDArrayIter(X, y, batch_size=BATCH)
    mod = mxt.mod.Module(_mlp(mxt, 0.0), context=mxt.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=_init_args(mxt), aux_params={})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.05),))
    return mod


def _fast_policy():
    return tfaults.RetryPolicy(attempts=3, base_s=0.0, jitter=0.0)


def _counter(name, **labels):
    m = mxt.telemetry.get_metric(name, **labels)
    return m.value if m is not None else 0


def _damage(path, how):
    p = os.path.join(path, "state.pkl")
    if how == "truncated":
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
    elif how == "corrupt":
        with open(p, "r+b") as f:
            f.seek(os.path.getsize(p) // 2)
            f.write(b"\xde\xad\xbe\xef" * 8)
    elif how == "no-state":
        os.remove(p)
    else:
        os.remove(os.path.join(path, "manifest.json"))


def _case_atomic_retention(d, monkeypatch):
    mod = _tiny_module()
    mgr = mxt.checkpoint.CheckpointManager(d, keep_last=2, async_write=False)
    for i in range(5):
        mgr.save(mod, epoch=0, nbatch=i)
    mgr.close()
    assert [s for s, _ in mxt.checkpoint.manager._committed(d)] == [4, 5]
    assert mxt.checkpoint.latest_checkpoint(d)[0] == 5
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    os.makedirs(os.path.join(d, "ckpt-00000099"))      # no manifest
    os.makedirs(os.path.join(d, ".tmp-ckpt-00000007-1"))
    assert mxt.checkpoint.latest_checkpoint(d)[0] == 5
    mgr2 = mxt.checkpoint.CheckpointManager(d, async_write=False)
    assert mgr2._seq == 6
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    mgr2.close()


def _case_async_wait(d, monkeypatch):
    mod = _tiny_module()
    with mxt.checkpoint.CheckpointManager(d, async_write=True) as mgr:
        mgr.save(mod, 0, 1)
        mgr.save(mod, 0, 2)
        mgr.wait()
        assert len(mgr.list_committed()) == 2
        assert mgr._thread.name == "mxnet-ckpt-writer"
    assert mxt.checkpoint.restore_module(_tiny_module(), d) == \
        {"epoch": 0, "nbatch": 2}


def _case_empty_dir(d, monkeypatch):
    assert mxt.checkpoint.restore_module(_tiny_module(), d) is None
    assert mxt.checkpoint.read_committed_payload(d) is None
    with pytest.raises(mxt.MXNetError, match="directory"):
        monkeypatch.delenv("MXNET_CKPT_DIR", raising=False)
        mxt.checkpoint.CheckpointManager()


def _case_env(d, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_DIR", d)
    monkeypatch.setenv("MXNET_CKPT_EVERY", "2")
    monkeypatch.setenv("MXNET_CKPT_KEEP_LAST", "2")
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    mgr = mxt.checkpoint.CheckpointManager()
    assert (mgr.directory, mgr.every_n_batches, mgr.keep_last,
            mgr.async_write) == (d, 2, 2, False)
    mgr.close()
    _run(mxt, num_epoch=1, ckpt=None, optimizer="sgd")
    assert len(mxt.checkpoint.manager._committed(d)) == 2
    assert _latest_cursor(d) == (1, 0)                 # the epoch-end save


def _case_telemetry(d, monkeypatch):
    mxt.telemetry.enable()
    try:
        mxt.telemetry.reset()
        _run(mxt, num_epoch=1, ckpt=d, every=2, optimizer="sgd")
        snap = mxt.telemetry.snapshot()
        assert snap["counters"].get("ckpt.snapshots", 0) == 6
        assert snap["counters"].get("ckpt.commits", 0) == 6
        assert snap["gauges"].get("ckpt.last_seq") == 6
        assert "ckpt.exposed_stall.seconds" in snap["histograms"]
        assert "ckpt.snapshot.seconds" in snap["histograms"]
        kinds = {r["kind"] for r in mxt.telemetry.flightrec.get_records()}
        assert {"ckpt.snapshot", "ckpt.commit"} <= kinds
    finally:
        mxt.telemetry.disable()
        mxt.telemetry.reset()


def _case_damaged(how):
    def case(d, monkeypatch):
        _run(mxt, kill_at=(0, 5), ckpt=d, every=2, optimizer="sgd")
        committed = mxt.checkpoint.manager._committed(d)
        assert len(committed) == 2                     # cursors 2 and 4
        before = _counter("ckpt.damaged")
        _damage(committed[-1][1], how)
        _, chains, _ = _run(mxt, resume=d, optimizer="sgd")
        assert min(chains) == (0, 2)
        if how != "no-manifest":        # not committed: nothing to read
            assert _counter("ckpt.damaged") == before + 1
    return case


def _case_quarantine(d, monkeypatch):
    mgr = mxt.checkpoint.CheckpointManager(d, retry_policy=_fast_policy())
    mod = _tiny_module()
    q0, f0 = _counter("ckpt.quarantined"), _counter("ckpt.failures")
    g0 = _counter("retry.giveups", site="ckpt.write")
    with tfaults.scope("ckpt.write:always"):
        bad = mgr.save(mod, 0, 1)
        with pytest.raises(tfaults.InjectedFault):
            mgr.wait()
    assert mgr.quarantined == [bad] and mgr.latest() is None
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    assert (_counter("ckpt.quarantined"), _counter("ckpt.failures"),
            _counter("retry.giveups", site="ckpt.write")) == \
        (q0 + 1, f0 + 1, g0 + 1)
    recs = [r for r in mxt.telemetry.flightrec.get_records()
            if r.get("kind") == "ckpt.quarantine"]
    assert recs and recs[-1]["seq"] == bad
    good = mgr.save(mod, 0, 2, block=True)   # the writer survived
    assert good == bad + 1
    assert [s for s, _ in mgr.list_committed()] == [good]
    mgr.close()


def _case_retried(point):
    def case(d, monkeypatch):
        mgr = mxt.checkpoint.CheckpointManager(d,
                                               retry_policy=_fast_policy())
        mod = _tiny_module()
        r0 = _counter("retry.retries", site="ckpt.write")
        with tfaults.scope(f"{point}:nth=1"):
            mgr.save(mod, 3, 5, block=True)
        assert _counter("retry.retries", site="ckpt.write") == r0 + 1
        assert mgr.quarantined == [] and mgr.latest() is not None
        mgr.close()
        other = _tiny_module()
        other.init_params(mxt.initializer.Xavier(), force_init=True)
        assert mxt.checkpoint.restore_module(other, d) == \
            {"epoch": 3, "nbatch": 5}
        a1, a2 = mod.get_params()[0], other.get_params()[0]
        for k in a1:
            np.testing.assert_array_equal(a1[k].asnumpy(), a2[k].asnumpy())
    return case


_CASES = {
    "atomic-retention": _case_atomic_retention,
    "async-wait": _case_async_wait,
    "empty-dir": _case_empty_dir,
    "env": _case_env,
    "telemetry": _case_telemetry,
    "damaged-truncated": _case_damaged("truncated"),
    "damaged-corrupt": _case_damaged("corrupt"),
    "damaged-no-state": _case_damaged("no-state"),
    "damaged-no-manifest": _case_damaged("no-manifest"),
    "quarantine": _case_quarantine,
    "retried-write": _case_retried("ckpt.write"),
    "retried-d2h": _case_retried("ckpt.d2h"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_manager_contract(case, tmp_path, monkeypatch):
    _CASES[case](str(tmp_path / "ck"), monkeypatch)


def test_retry_policy_from_env(monkeypatch):
    """``MXNET_RETRY_CKPT`` tunes the manager's policy; a bad key raises."""
    monkeypatch.setenv("MXNET_RETRY_CKPT", "attempts=5,base=0.1,deadline=60")
    pol = tfaults.RetryPolicy.from_env("CKPT", attempts=3)
    assert (pol.attempts, pol.base_s, pol.deadline_s) == (5, 0.1, 60.0)
    monkeypatch.setenv("MXNET_RETRY_CKPT", "tries=5")
    with pytest.raises(mxt.MXNetError, match="unknown key"):
        tfaults.RetryPolicy.from_env("CKPT")


def test_capture_refuses_a_bucketing_module():
    bm = mxt.mod.BucketingModule(
        lambda key: (_mlp(mxt, 0.0), ["data"], ["softmax_label"]),
        default_bucket_key=BATCH, context=mxt.cpu())
    with pytest.raises(mxt.MXNetError, match="BucketingModule"):
        tstate.capture(bm)


# ------------------------------------------------------ (e) not torn
def test_snapshot_is_not_torn_by_later_updates(tmp_path, monkeypatch):
    """The writer is held back while two more updates rewrite the weights
    and Adam states in place; the commit still holds the values of the
    step it was taken at."""
    X, y = _data()
    it = mxt.io.NDArrayIter(X, y, batch_size=BATCH)
    mod = mxt.mod.Module(_mlp(mxt), context=mxt.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=_init_args(mxt))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params=(("learning_rate", 0.05),))
    batches = iter(it)
    mod.forward_backward(next(batches))
    mod.update()
    want = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    want_states = {k: [a.copy() for a in v]
                   for k, v in _port_states(mod).items()}

    release, entered = threading.Event(), threading.Event()
    plain = tstate.to_host

    def held(snapshot):
        entered.set()
        assert release.wait(30)
        return plain(snapshot)
    monkeypatch.setattr(tstate, "to_host", held)
    mgr = mxt.checkpoint.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(mod, 0, 1)
    assert entered.wait(30)
    for _ in range(2):
        mod.forward_backward(next(batches))
        mod.update()
    moved = mod.get_params()[0]["fc1_weight"].asnumpy()
    assert not np.array_equal(moved, want["fc1_weight"])
    release.set()
    mgr.wait()
    mgr.close()
    _, _, payload = mxt.checkpoint.read_committed_payload(
        str(tmp_path / "ck"))
    for k, v in want.items():
        np.testing.assert_array_equal(payload["device"]["arg_params"][k], v)
    for k, v in want_states.items():
        for x, z in zip(payload["device"]["opt_states"][k], v):
            np.testing.assert_array_equal(x, z)
