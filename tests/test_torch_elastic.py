"""The port's elastic layer (``horovod_tpu_torch/elastic``,
``torch/elastic.py``) against the JAX package's, on the CPU.

Each of the 21 scenarios of the reference's ``tests/test_elastic.py``
(``HostManager``, ``WorkerStateRegistry``, ``ElasticDriver`` with mock
workers, ``ElasticSampler``, ``ObjectState`` and ``ArrayState``) runs on
both packages; each side passes the reference's assertions and the two
return the same record (assignments, blacklists, reshards, restored
values).  Beyond them:

- ``ArrayState`` over the port's ``TrainState`` (gpt_tiny's parameters,
  converted by ``convert.params_from_flax`` from the flax tree) against
  the reference's ``ArrayState`` over the flax tree: after a commit, a
  change and a restore, the saved and the restored leaves are equal;
- ``TorchState`` of each package on one seeded module and its optimizer:
  after a commit, a change and a restore, the parameters and the
  optimizer state are bitwise equal, in both packages;
- the shrink policy's driver half (``apply_shrink``), ``kv_barrier``,
  ``core.reinit_world`` and the ``HOROVOD_HOST_IDS`` topology.
"""
from __future__ import annotations

import importlib
import os
import threading
import time
import types
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_sigterm import restore_sigterm  # noqa: F401

PACKAGES = ("horovod_tpu", "horovod_tpu_torch")


def _mods(package: str) -> types.SimpleNamespace:
    disc = importlib.import_module(f"{package}.elastic.discovery")
    reg = importlib.import_module(f"{package}.elastic.registration")
    drv = importlib.import_module(f"{package}.elastic.driver")
    smp = importlib.import_module(f"{package}.elastic.sampler")

    class SequenceDiscovery(disc.HostDiscovery):
        """Replays a schedule of host dicts; sticks on the last one."""

        def __init__(self, *rounds):
            self._rounds = list(rounds)
            self.calls = 0

        def find_available_hosts_and_slots(self):
            idx = min(self.calls, len(self._rounds) - 1)
            self.calls += 1
            return OrderedDict(self._rounds[idx])

    return types.SimpleNamespace(
        HostManager=disc.HostManager, FixedHostDiscovery=disc.
        FixedHostDiscovery, HostUpdateResult=disc.HostUpdateResult,
        SequenceDiscovery=SequenceDiscovery,
        WorkerStateRegistry=reg.WorkerStateRegistry, READY=reg.READY,
        SUCCESS=reg.SUCCESS, FAILURE=reg.FAILURE,
        ElasticDriver=drv.ElasticDriver, ElasticSampler=smp.ElasticSampler)


# ---------------------------------------------------------------------------
# HostManager / discovery
# ---------------------------------------------------------------------------
def host_update_added_removed(m):
    disc = m.SequenceDiscovery({"a": 2}, {"a": 2, "b": 2}, {"b": 2})
    mgr = m.HostManager(disc)
    out = []
    for want in (m.HostUpdateResult.ADDED, m.HostUpdateResult.ADDED,
                 m.HostUpdateResult.REMOVED):
        assert mgr.update_available_hosts() == want
        out.append(dict(mgr.current_hosts))
    assert out == [{"a": 2}, {"a": 2, "b": 2}, {"b": 2}]
    return out


def host_no_update(m):
    mgr = m.HostManager(m.FixedHostDiscovery(OrderedDict(a=2)))
    res = [mgr.update_available_hosts(), mgr.update_available_hosts()]
    assert res == [m.HostUpdateResult.ADDED, m.HostUpdateResult.NO_UPDATE]
    return res


def host_blacklist_excludes_host(m):
    mgr = m.HostManager(m.FixedHostDiscovery(OrderedDict(a=2, b=2)))
    mgr.update_available_hosts()
    mgr.blacklist("a")
    assert mgr.is_blacklisted("a")
    assert set(mgr.current_hosts) == {"b"}
    # Re-discovery never resurrects a blacklisted host.
    mgr.update_available_hosts()
    assert set(mgr.current_hosts) == {"b"}
    return sorted(mgr.blacklisted_hosts), dict(mgr.current_hosts)


def host_slot_count_change_is_update(m):
    mgr = m.HostManager(m.SequenceDiscovery({"a": 2}, {"a": 4}))
    mgr.update_available_hosts()
    res = mgr.update_available_hosts()
    assert res == m.HostUpdateResult.MIXED
    return res, dict(mgr.current_hosts)


# ---------------------------------------------------------------------------
# WorkerStateRegistry
# ---------------------------------------------------------------------------
class FakeDriver:
    def __init__(self):
        self.stopped = False
        self.resumed = 0
        self.limit_exceeded = False

    def finished(self):
        return self.stopped

    def stop(self):
        self.stopped = True

    def resume(self):
        self.resumed += 1

    def set_reset_limit_exceeded(self):
        self.limit_exceeded = True


def _registry(m, size, reset_limit=None):
    driver = FakeDriver()
    mgr = m.HostManager(m.FixedHostDiscovery(OrderedDict(a=size)))
    mgr.update_available_hosts()
    reg = m.WorkerStateRegistry(driver, mgr, reset_limit=reset_limit)
    reg.reset(size)
    return driver, mgr, reg


def _registry_record(driver, mgr, reg, m):
    return {"stopped": driver.stopped, "resumed": driver.resumed,
            "limit": driver.limit_exceeded,
            "blacklist": sorted(mgr.blacklisted_hosts),
            "counts": [reg.count(s) for s in (m.READY, m.SUCCESS,
                                              m.FAILURE)],
            "round": reg.rendezvous_id}


def registry_all_success_stops_driver(m):
    driver, mgr, reg = _registry(m, 2)
    reg.record_success("a", 0)
    assert not driver.stopped
    reg.record_success("a", 1)
    assert driver.stopped and driver.resumed == 0
    return _registry_record(driver, mgr, reg, m)


def registry_failure_blacklists_and_resumes(m):
    driver, mgr, reg = _registry(m, 2)
    reg.record_failure("a", 0)
    reg.record_ready("a", 1)
    assert driver.resumed == 1
    assert mgr.is_blacklisted("a")
    return _registry_record(driver, mgr, reg, m)


def registry_all_ready_resumes(m):
    driver, mgr, reg = _registry(m, 2)
    reg.record_ready("a", 0)
    reg.record_ready("a", 1)
    assert driver.resumed == 1 and not driver.stopped
    return _registry_record(driver, mgr, reg, m)


def registry_failure_overrides_ready(m):
    driver, mgr, reg = _registry(m, 2)
    reg.record_ready("a", 0)
    assert reg.count(m.READY) == 1
    reg.record_failure("a", 0)
    assert reg.count(m.READY) == 0 and reg.count(m.FAILURE) == 1
    # READY never downgrades a terminal state.
    reg.record_ready("a", 0)
    assert reg.count(m.FAILURE) == 1
    return _registry_record(driver, mgr, reg, m)


def registry_stale_slot_records_ignored(m):
    driver, mgr, reg = _registry(m, 2)
    reg.reset(2, expected_slots=["a[0]", "a[1]"])
    reg.record_failure("zombie", 0)
    reg.record_ready("a", 0)
    assert driver.resumed == 0         # only 1/2 expected recorded
    reg.record_ready("a", 1)
    assert driver.resumed == 1
    return _registry_record(driver, mgr, reg, m)


def registry_ready_bound_to_round(m):
    driver, mgr, reg = _registry(m, 2)
    current = reg.rendezvous_id
    reg.reset(2)                        # round advances concurrently
    reg.record_ready("a", 0, round_id=current)
    assert reg.count(m.READY) == 0
    return _registry_record(driver, mgr, reg, m)


def registry_reset_limit(m):
    driver, mgr, reg = _registry(m, 2, reset_limit=1)
    reg.record_failure("a", 0)
    reg.record_ready("a", 1)
    assert driver.limit_exceeded and driver.stopped
    return _registry_record(driver, mgr, reg, m)


# ---------------------------------------------------------------------------
# ElasticDriver state machine (mock workers)
# ---------------------------------------------------------------------------
def _idle_worker_fn(stop_events):
    """create_worker_fn whose processes live until their stop event fires."""
    def create(slot):
        ev = threading.Event()
        stop_events[(slot.hostname, slot.local_rank)] = ev
        ev.wait(timeout=30)
        return 0
    return create


def _strip(assignment):
    """An assignment without its notification clock, which counts the
    discovery thread's polls and so depends on timing."""
    if assignment is None:
        return None
    return {k: v for k, v in assignment.items() if k != "notify_ts"}


def _request_all(driver, slots, min_epoch):
    results = {}

    def request(h, s):
        results[(h, s)] = driver.get_assignment(h, s, min_epoch)

    threads = [threading.Thread(target=request, args=hs) for hs in slots]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert all(not t.is_alive() for t in threads)
    return {f"{h}[{s}]": _strip(a) for (h, s), a in sorted(results.items())}


def driver_initial_round_assignments(m):
    driver = m.ElasticDriver(m.FixedHostDiscovery(OrderedDict(a=2, b=2)),
                             min_np=4, timeout=5)
    stops = {}
    driver.start(4, _idle_worker_fn(stops))
    try:
        got = {(h, s): driver.get_assignment(h, s, 0)
               for h, s in [("a", 0), ("a", 1), ("b", 0), ("b", 1)]}
        assert sorted(a["rank"] for a in got.values()) == [0, 1, 2, 3]
        assert all(a["size"] == 4 and a["epoch"] == 1
                   for a in got.values())
        assert got[("a", 0)]["cross_size"] == 2
        assert got[("a", 0)]["local_size"] == 2
        return {f"{h}[{s}]": _strip(a) for (h, s), a in got.items()}
    finally:
        driver.stop()
        for ev in stops.values():
            ev.set()


def driver_host_added_new_round_preserves_ranks(m):
    driver = m.ElasticDriver(m.SequenceDiscovery({"a": 2},
                                                 {"a": 2, "b": 2}),
                             min_np=2, max_np=4, timeout=5)
    stops = {}
    driver.start(2, _idle_worker_fn(stops))
    try:
        first = {(h, s): driver.get_assignment(h, s, 0)
                 for h, s in [("a", 0), ("a", 1)]}
        assert first[("a", 0)]["rank"] == 0
        assert first[("a", 1)]["rank"] == 1
        results = _request_all(driver, [("a", 0), ("a", 1)], 2)
        assert results["a[0]"]["rank"] == 0
        assert results["a[0]"]["size"] == 4
        b0 = driver.get_assignment("b", 0, 2)
        assert b0["size"] == 4
        assert b0["epoch"] == results["a[0]"]["epoch"]
        return results, _strip(b0)
    finally:
        driver.stop()
        for ev in stops.values():
            ev.set()


def driver_worker_failure_blacklists_host_and_reforms(m):
    driver = m.ElasticDriver(m.FixedHostDiscovery(OrderedDict(a=2, b=2)),
                             min_np=2, max_np=4, timeout=5)
    stops = {}
    fail_b = threading.Event()

    def create(slot):
        if slot.hostname == "b":
            fail_b.wait(timeout=30)
            return 1          # both b workers die
        ev = threading.Event()
        stops[(slot.hostname, slot.local_rank)] = ev
        ev.wait(timeout=30)
        return 0

    driver.start(4, create)
    try:
        assert driver.get_assignment("a", 0, 0)["size"] == 4
        fail_b.set()
        results = _request_all(driver, [("a", 0), ("a", 1)], 2)
        assert results["a[0]"]["size"] == 2
        assert results["a[0]"]["rank"] == 0
        assert results["a[1]"]["rank"] == 1
        return results
    finally:
        driver.stop()
        for ev in stops.values():
            ev.set()


def driver_dropped_slot_gets_none(m):
    driver = m.ElasticDriver(m.SequenceDiscovery({"a": 1, "b": 1},
                                                 {"a": 1}),
                             min_np=1, max_np=2, timeout=5)
    stops = {}
    driver.start(2, _idle_worker_fn(stops))
    try:
        assert driver.get_assignment("b", 0, 0)["size"] == 2
        results = _request_all(driver, [("a", 0), ("b", 0)], 2)
        assert results["a[0]"]["size"] == 1
        assert results["b[0]"] is None   # b left the world
        return results
    finally:
        driver.stop()
        for ev in stops.values():
            ev.set()


def driver_all_success_finishes_job(m):
    driver = m.ElasticDriver(m.FixedHostDiscovery(OrderedDict(a=2)),
                             min_np=2, timeout=5)

    def create(slot):
        driver.get_assignment(slot.hostname, slot.local_rank, 0)
        return 0

    driver.start(2, create)
    assert driver.join(timeout=10)
    assert driver.finished()
    results = driver.get_results()
    assert all(code == 0 for code, _ in results.values())
    return sorted((name, code) for name, (code, _) in results.items())


# ---------------------------------------------------------------------------
# ElasticSampler
# ---------------------------------------------------------------------------
def sampler_partitions_evenly(m):
    data = list(range(10))
    s = m.ElasticSampler(data, shuffle=False)
    assert sorted(s.indices) == data
    return list(s.indices)


def sampler_reshard_after_processing(m):
    data = list(range(8))
    s = m.ElasticSampler(data, shuffle=False)
    s.record_indices([0, 1, 2])
    s.reset()
    assert set(s.indices) == {3, 4, 5, 6, 7}
    first = list(s.indices)
    s.set_epoch(1)
    assert sorted(set(s.indices)) == data
    return first, list(s.indices)


def sampler_state_roundtrip(m):
    s = m.ElasticSampler(list(range(6)), shuffle=True, seed=3)
    s.record_indices([1, 5])
    s.reset()
    state = s.state_dict()
    s2 = m.ElasticSampler(list(range(6)), shuffle=True, seed=3)
    s2.load_state_dict(state)
    assert set(s2.indices) == set(s.indices)
    assert s2.processed_indices == {1, 5}
    return list(s.indices), list(s2.indices), state


# ---------------------------------------------------------------------------
# State commit/restore (a world of one, no driver)
# ---------------------------------------------------------------------------
def _world_of_one(package):
    hvd = importlib.import_module(package)
    hvd.init()
    return hvd


def state_object_commit_restore(m):
    hvd = _world_of_one(m.package)
    try:
        ObjectState = importlib.import_module(
            f"{m.package}.elastic").ObjectState
        state = ObjectState(epoch=0, batch=0)
        state.epoch = 5
        state.commit()
        state.epoch = 9
        state.restore()
        assert state.epoch == 5
        state.sync()     # size-1 world: round-trips through broadcast
        assert state.epoch == 5
        return state.epoch, state.batch
    finally:
        hvd.shutdown()


def state_array_commit_restore_sync(m):
    hvd = _world_of_one(m.package)
    try:
        ArrayState = importlib.import_module(
            f"{m.package}.elastic").ArrayState
        if m.package == "horovod_tpu":
            def full(shape, v):
                return jnp.full(shape, v, jnp.float32)
        else:
            def full(shape, v):
                return torch.full(shape, v, dtype=torch.float32)
        state = ArrayState(trees={"params": {"w": full((4, 4), 1.0),
                                             "b": full((4,), 0.0)}},
                           epoch=1)
        state.commit()
        state.set_tree("params", {"w": full((4, 4), 7.0),
                                  "b": full((4,), 7.0)})
        state.restore()
        np.testing.assert_allclose(
            np.asarray(state.tree("params")["w"]), np.ones((4, 4)))
        state.sync()
        np.testing.assert_allclose(
            np.asarray(state.tree("params")["b"]), np.zeros((4,)))
        assert state.epoch == 1
        return {k: np.asarray(v).tolist()
                for k, v in state.tree("params").items()}, state.epoch
    finally:
        hvd.shutdown()


SCENARIOS = [
    host_update_added_removed, host_no_update, host_blacklist_excludes_host,
    host_slot_count_change_is_update,
    registry_all_success_stops_driver,
    registry_failure_blacklists_and_resumes, registry_all_ready_resumes,
    registry_failure_overrides_ready, registry_stale_slot_records_ignored,
    registry_ready_bound_to_round, registry_reset_limit,
    driver_initial_round_assignments,
    driver_host_added_new_round_preserves_ranks,
    driver_worker_failure_blacklists_host_and_reforms,
    driver_dropped_slot_gets_none, driver_all_success_finishes_job,
    sampler_partitions_evenly, sampler_reshard_after_processing,
    sampler_state_roundtrip, state_object_commit_restore,
    state_array_commit_restore_sync,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_reference(scenario):
    records = []
    for package in PACKAGES:
        m = _mods(package)
        m.package = package
        records.append(scenario(m))
    assert records[0] == records[1]


# ---------------------------------------------------------------------------
# ArrayState over TrainState, TorchState, shrink, kv_barrier
# ---------------------------------------------------------------------------
def test_array_state_over_train_state_matches_the_reference():
    from horovod_tpu import elastic as jel
    from horovod_tpu.models import transformer as jtr
    import horovod_tpu as jhvd

    import horovod_tpu_torch as thvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch import elastic as tel
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.training import TrainState

    jcfg = jtr.gpt_tiny(dtype=jnp.float32)
    flax_params = jtr.TransformerLM(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = ttr.gpt_tiny(dtype=torch.float32)
    model = ttr.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(flax_params, tcfg))
    train_state = TrainState(step=0, model=model,
                             optimizer=torch.optim.AdamW(model.parameters()))

    jhvd.init()
    thvd.init()
    try:
        ref = jel.ArrayState(trees={"params": flax_params}, step=0)
        port = tel.ArrayState(trees={"params": dict(train_state.params)},
                              step=0)
        ref.commit()
        port.commit()
        ref.set_tree("params", jax.tree_util.tree_map(
            lambda x: x * 0 + 7.0, flax_params))
        port.set_tree("params", {k: torch.full_like(v, 7.0)
                                 for k, v in train_state.params.items()})
        ref.step = port.step = 3
        ref.restore()
        port.restore()
        assert ref.step == port.step == 0

        def as_flax(tree):
            return convert.params_to_flax(
                {k: v.detach() for k, v in tree.items()}, tcfg)

        saved = tel.state.tree_unflatten(port._treedefs["params"],
                                         port._saved_trees["params"])
        ref_saved = jax.tree_util.tree_unflatten(
            ref._treedefs["params"], ref._saved_trees["params"])
        for got in (as_flax(saved), as_flax(port.tree("params"))):
            for want_tree in (ref_saved, ref.tree("params")):
                jax.tree_util.tree_map(
                    lambda a, b: np.testing.assert_array_equal(
                        np.asarray(a), np.asarray(b)), got, want_tree)
        # Every saved leaf is a host copy; the restored ones are new
        # tensors on their device, not the saved copies.
        assert all(leaf.device.type == "cpu"
                   for leaf in port._saved_trees["params"])
        restored = tel.state.tree_flatten(port.tree("params"))[0]
        assert not any(a.data_ptr() == b.data_ptr() for a, b in
                       zip(restored, port._saved_trees["params"]))
        port.sync()
        as_flax(port.tree("params"))
    finally:
        thvd.shutdown()
        jhvd.shutdown()


def _torch_state(package):
    TorchState = importlib.import_module(f"{package}.torch.elastic") \
        .TorchState
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(),
                                torch.nn.Linear(5, 3))
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    return model, opt, TorchState(model, opt, step=0)


def _train_step(model, opt, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    opt.zero_grad()
    model(x).square().mean().backward()
    opt.step()


def _snapshot(model, opt):
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ostate = {(i, k): v.clone() if torch.is_tensor(v) else v
              for i, s in opt.state_dict()["state"].items()
              for k, v in s.items()}
    return params, ostate


def _bitwise_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(
                a[k].view(-1).view(torch.uint8)
                if a[k].dtype != torch.bool else a[k],
                b[k].view(-1).view(torch.uint8)
                if b[k].dtype != torch.bool else b[k]), k
        else:
            assert a[k] == b[k], k


def test_torch_state_commit_restore_matches_the_reference():
    import horovod_tpu as jhvd
    import horovod_tpu_torch as thvd

    jhvd.init()
    thvd.init()
    try:
        snaps = {}
        for package in PACKAGES:
            model, opt, state = _torch_state(package)
            _train_step(model, opt, 1)
            state.step = 1
            state.commit()
            committed = _snapshot(model, opt)
            _train_step(model, opt, 2)
            state.step = 2
            changed = _snapshot(model, opt)
            assert not torch.equal(changed[0]["0.weight"],
                                   committed[0]["0.weight"])
            state.restore()
            # The port restores the committed plain value, as upstream
            # does; the reference keeps the one set after the commit
            # (its __setattr__ overwrites the saved copy; ROADMAP C).
            assert state.step == (1 if package == "horovod_tpu_torch"
                                  else 2)
            restored = _snapshot(model, opt)
            for got, want in zip(restored, committed):
                _bitwise_equal(got, want)
            state.sync()             # a world of one: broadcasts to itself
            for got, want in zip(_snapshot(model, opt), committed):
                _bitwise_equal(got, want)
            snaps[package] = restored
        for got, want in zip(snaps["horovod_tpu_torch"],
                             snaps["horovod_tpu"]):
            _bitwise_equal(got, want)
    finally:
        thvd.shutdown()
        jhvd.shutdown()


def test_apply_shrink_blacklists_and_the_driver_resumes():
    """The reference's shrink scenario on both packages: rank 2 of 4
    dies, the driver half blacklists its host, and the three survivors
    re-form a world of three."""
    finals = []
    for package in PACKAGES:
        m = _mods(package)
        policy = importlib.import_module(f"{package}.resilience.policy")
        hosts = OrderedDict((f"h{i}", 1) for i in range(4))
        driver = m.ElasticDriver(m.FixedHostDiscovery(hosts), min_np=3,
                                 max_np=4, timeout=20.0)
        release = threading.Event()
        driver.start(np=4, create_worker_fn=lambda slot:
                     0 if release.wait(30.0) else 1)
        try:
            epoch0 = driver.current_epoch
            slots = driver.rank_to_slot()
            assert policy.apply_shrink(driver, {2}) == \
                {2: slots[2].hostname}
            for r in (0, 1, 3):
                driver.record_ready(slots[r].hostname, slots[r].local_rank)
            deadline = time.monotonic() + 15.0
            while driver.current_epoch == epoch0 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert driver.current_epoch > epoch0, "no new round formed"
            assert driver.world_size() == 3
            finals.append(driver.final_slots())
        finally:
            release.set()
            driver.stop()
            driver.shutdown()
    assert finals[0] == finals[1]
    assert "h2[0]" not in finals[1].values()


def test_kv_barrier_waits_and_names_the_missing_rank():
    """``kv_barrier`` of a two-rank world, the peer faked by hand: it
    waits for the slower rank, and a rank alone times out naming the
    missing one."""
    from horovod_tpu_torch.parallel import multihost
    from horovod_tpu_torch.runner.network import (RendezvousClient,
                                                  RendezvousServer)

    server = RendezvousServer()
    port = server.start()
    try:
        kv = RendezvousClient("127.0.0.1", port, 10.0)
        # One process holds one group: fake the second rank's half of
        # the barrier by hand, as a peer process would write it.
        multihost._world = (0, 2, kv, "kvb")
        multihost._barrier_seq = 0
        multihost._initialized_here = True
        released = []

        def peer():
            time.sleep(0.3)
            # Stamped before the write: the barrier may see the key and
            # return before this thread runs again.
            released.append(time.monotonic())
            kv.put("barrier", "kvb:t:1:1", b"1")

        t = threading.Thread(target=peer)
        t.start()
        multihost.kv_barrier("t", timeout=10.0)
        done = time.monotonic()
        t.join(timeout=5)
        assert released and done >= released[0]
        with pytest.raises(TimeoutError, match=r"missing ranks: \[1\]"):
            multihost.kv_barrier("u", timeout=0.5)
    finally:
        multihost._world = None
        multihost._initialized_here = False
        server.stop()


def test_reinit_world_reforms_a_world_of_one(monkeypatch):
    """``core.reinit_world`` (the reference's elastic primitive): the
    world goes down and comes back under the new epoch, rank and size,
    which the environment keeps for any later env-driven init."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import core

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_RENDEZVOUS_EPOCH"):
        monkeypatch.delenv(var, raising=False)
    hvd.init()
    try:
        assert hvd.allreduce(torch.ones(2), op=hvd.Sum).tolist() == [1, 1]
        core.reinit_world(rank=0, size=1, epoch="e7")
        assert hvd.is_initialized() and (hvd.rank(), hvd.size()) == (0, 1)
        assert os.environ["HOROVOD_RENDEZVOUS_EPOCH"] == "e7"
        assert (os.environ["HOROVOD_RANK"], os.environ["HOROVOD_SIZE"]) \
            == ("0", "1")
        assert hvd.allreduce(torch.ones(2), op=hvd.Sum).tolist() == [1, 1]
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("size,local,cross,hosts", [
    (4, 2, 2, (0, 0, 1, 1)), (3, 1, 1, (0, 1, 1)), (5, 1, 1, (1, 0, 1, 0, 2)),
    (4, 4, 1, (0, 0, 0, 0)), (4, 2, 2, None), (3, 1, 1, (0, 1)),
])
def test_host_ids_topology_matches_the_reference(monkeypatch, size, local,
                                                 cross, hosts):
    """``HOROVOD_HOST_IDS``, which the launcher and the driver now set:
    the same topology and ring order in both packages."""
    from horovod_tpu.common import topology as jtopo
    from horovod_tpu_torch.common import topology as ttopo

    monkeypatch.delenv("HOROVOD_TOPOLOGY", raising=False)
    ref = jtopo.resolve(size, local, cross, hosts=hosts)
    port = ttopo.resolve(size, local, cross, hosts=hosts)
    assert (port.kind, port.ring_order()) == (ref.kind, ref.ring_order())


_REFORM = r"""
import os, sys, torch, torch.distributed as dist
from horovod_tpu_torch.parallel import multihost
from horovod_tpu_torch.runner.network import RendezvousClient
torch.set_num_threads(1)
rank, port = int(sys.argv[1]), int(sys.argv[2])
kv = RendezvousClient("127.0.0.1", port, 30.0)
sums = []
for epoch in ("1", "2"):
    os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = epoch
    assert multihost.init_process_group(rank, 2, kv, backend="gloo",
                                        timeout=30.0)
    t = torch.full((3,), float(rank + 1) * int(epoch))
    dist.all_reduce(t)
    multihost.kv_barrier("reform", timeout=30.0)
    sums.append(t.tolist())
    multihost.shutdown()
    assert not dist.is_initialized() and not multihost.is_initialized()
print("SUMS", sums)
"""


def test_gloo_group_reforms_under_the_next_epoch():
    """What ``HOROVOD_ELASTIC`` means in the port: ``shutdown`` destroys
    the world's process group, and the next epoch forms it again under
    its own store key (``ncclstore/store:<epoch>``); ``kv_barrier``
    starts its sequence anew with each group.  Two ranks, gloo."""
    import subprocess
    import sys

    from horovod_tpu_torch.runner.network import RendezvousServer

    server = RendezvousServer()
    port = server.start()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    try:
        procs = [subprocess.Popen([sys.executable, "-c", _REFORM, str(r),
                                   str(port)], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs
        for out in outs:
            assert "SUMS [[3.0, 3.0, 3.0], [6.0, 6.0, 6.0]]" in out, out
        assert server.get("ncclstore", "store:1") != \
            server.get("ncclstore", "store:2")
    finally:
        server.stop()
