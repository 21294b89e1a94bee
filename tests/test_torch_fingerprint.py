"""The port's collective fingerprint against the JAX package's, in one
process (after ``tests/test_fingerprint.py:33-186``).

The same request streams go through both trackers: the descriptors,
the rolling digests, the bounded tails, the located divergence and its
report text are the reference's, and so are a RequestList's wire bytes
with a fingerprint on it and the coordinator's structured ERROR (with
its flight-recorder record).
"""
from __future__ import annotations

import pytest

from horovod_tpu.analysis import fingerprint as ref_fp
from horovod_tpu.common import controller as ref_ctl
from horovod_tpu.common import message as ref_msg
from horovod_tpu.common import tensor_queue as ref_tq
from horovod_tpu.common.dtypes import DataType as RefDT
from horovod_tpu.telemetry import flight as ref_flight
from horovod_tpu_torch.analysis import fingerprint as port_fp
from horovod_tpu_torch.common import controller as port_ctl
from horovod_tpu_torch.common import message as port_msg
from horovod_tpu_torch.common import tensor_queue as port_tq
from horovod_tpu_torch.common.dtypes import DataType as PortDT
from horovod_tpu_torch.telemetry import flight as port_flight

SIDES = {"port": (port_fp, port_msg, PortDT),
         "ref": (ref_fp, ref_msg, RefDT)}

# Request streams: (name, op, dtype, shape, codec, block, spec).
_AR = ("ALLREDUCE", "FLOAT32", (4,), 0, 0, "")
BASE = [(f"t{i}",) + _AR for i in range(10)]
STREAMS = {
    "same": (BASE, BASE),
    "ahead": (BASE, BASE[:4]),
    "renamed": (BASE[:3] + [("x",) + _AR] + BASE[4:],
                BASE[:3] + [("y",) + _AR] + BASE[4:]),
    "reshaped": (BASE[:5] + [("t5", "ALLREDUCE", "FLOAT32", (2, 3), 0, 0,
                              "")],
                 BASE[:5] + [("t5", "ALLREDUCE", "FLOAT32", (3, 2), 0, 0,
                              "")]),
    "op": ([("a", "ALLREDUCE", "FLOAT16", (8,), 2, 0, "")],
           [("a", "BROADCAST", "FLOAT16", (8,), 2, 0, "")]),
    "codec": ([("g", "ALLREDUCE", "BFLOAT16", (5, 5), 3, 128, "")],
              [("g", "ALLREDUCE", "BFLOAT16", (5, 5), 3, 64, "")]),
    "gather": ([("done", "ALLGATHER", "INT32", (204, 2), 0, 0, "")],
               [("done", "ALLGATHER", "INT32", (5, 2), 0, 0, "")]),
    "gather_trailing": ([("done", "ALLGATHER", "INT32", (204, 2), 0, 0, "")],
                        [("done", "ALLGATHER", "INT32", (5, 3), 0, 0, "")]),
    "spec": ([("w", "ALLREDUCE", "FLOAT32", (4, 8), 0, 0, "(dp,tp)")],
             [("w", "ALLREDUCE", "FLOAT32", (4, 8), 0, 0, "(fsdp,tp)")]),
    "spec_dim0": ([("w", "ALLGATHER", "FLOAT32", (4, 8), 0, 0, "(dp,tp)")],
                  [("w", "ALLGATHER", "FLOAT32", (4, 8), 0, 0, "(sp,tp)")]),
    "scalar": ([("s", "REDUCESCATTER", "INT64", (), 0, 0, "")],
               [("s", "REDUCESCATTER", "INT64", (1,), 0, 0, "")]),
    "early": ([("DIFF0",) + _AR] + BASE, [("DIFF1",) + _AR] + BASE),
    "join": ([("__join__", "JOIN", "FLOAT32", (), 0, 0, "")] + BASE[:2],
             BASE[:2]),
}


def _req(side, rank, rec):
    _, msg, dt = SIDES[side]
    name, op, dtype, shape, codec, block, spec = rec
    return msg.Request(request_rank=rank, request_type=msg.RequestType[op],
                       tensor_type=dt[dtype], tensor_name=name,
                       tensor_shape=shape, codec=codec,
                       codec_block_size=block, sp_spec=spec)


def _trackers(side, streams, mode="cycle", window=64, fold_spec=True):
    fp = SIDES[side][0]
    out = []
    for rank, stream in enumerate(streams):
        t = fp.FingerprintTracker(mode, window)
        t.fold_spec = fold_spec
        for rec in stream:
            req = _req(side, rank, rec)
            t.fold(req)
            t.fold(req)                 # a re-popped request folds once
        out.append(t)
    return out


def _record(side, streams, window, fold_spec):
    trackers = _trackers(side, streams, window=window, fold_spec=fold_spec)
    snaps = [t.snapshot() for t in trackers]
    div = SIDES[side][0].find_divergence(snaps)
    return ([(seq, digest, [(r.seq, r.digest, r.descriptor, r.tensor_name)
                            for r in tail]) for seq, digest, tail in snaps],
            None if div is None else
            (div.seq, div.exact, div.descriptors, div.tensor_names(),
             div.message()))


@pytest.mark.parametrize("window", [64, 4])
@pytest.mark.parametrize("fold_spec", [True, False])
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_streams_give_the_reference_digests_and_report(case, window,
                                                       fold_spec):
    port = _record("port", STREAMS[case], window, fold_spec)
    ref = _record("ref", STREAMS[case], window, fold_spec)
    assert port == ref
    div = port[1]
    if case in ("same", "ahead", "gather", "join") or \
            (case in ("spec", "spec_dim0") and
             (not fold_spec or case == "spec_dim0")):
        assert div is None, div
    else:
        assert div is not None and "Collective fingerprint divergence" \
            in div[4]


@pytest.mark.parametrize("rec", sorted({r for pair in STREAMS.values()
                                        for s in pair for r in s}, key=str))
def test_descriptor_is_the_reference(rec):
    for with_spec in (True, False):
        assert port_fp.describe(_req("port", 0, rec), with_spec) == \
            ref_fp.describe(_req("ref", 0, rec), with_spec)
    from horovod_tpu.analysis.hvdshard.specs import fold_token
    assert port_fp.fold_token(rec[1], rec[6]) == fold_token(rec[1], rec[6])


def test_modes_window_and_report_once():
    for side in SIDES:
        fp = SIDES[side][0]
        assert fp.FingerprintMode.parse("STRICT") is fp.FingerprintMode.STRICT
        assert fp.FingerprintMode.parse("bogus") is fp.FingerprintMode.OFF
        off = fp.FingerprintTracker("off")
        off.fold(_req(side, 0, BASE[0]))
        assert not off.enabled and off.seq == 0
    pairs = {side: _trackers(side, STREAMS["renamed"], window=4)
             for side in SIDES}
    for side, (a, b) in pairs.items():
        assert [r.seq for r in a.snapshot()[2]] == [7, 8, 9, 10]
        triples = [a.snapshot(), b.snapshot()]
        first = a.check_gathered(triples)
        assert first is not None and not first.exact
        assert a.check_gathered(triples) is None      # reported once
        a.reset()
        assert a.seq == 0 and a.check_gathered(triples) is not None


def _fp_list(side, rank, tracker, requests):
    msg = SIDES[side][1]
    rl = msg.RequestList(requests=requests, shutdown=False)
    seq, digest, tail = tracker.snapshot()
    rl.fp_seq, rl.fp_digest = seq, digest
    rl.fp_tail_seqs = [r.seq for r in tail]
    rl.fp_tail_digests = [r.digest for r in tail]
    rl.fp_tail_descs = [r.descriptor for r in tail]
    return rl


def test_requestlist_with_a_fingerprint_is_the_reference_bytes():
    wires = {}
    for side in SIDES:
        (t, _) = _trackers(side, STREAMS["renamed"])
        rl = _fp_list(side, 0, t, [_req(side, 0, BASE[2])])
        raw = rl.to_bytes()
        back = SIDES[side][1].RequestList.from_bytes(raw)
        assert (back.fp_seq, back.fp_digest, back.fp_tail_seqs,
                back.fp_tail_digests, back.fp_tail_descs) == (
            rl.fp_seq, rl.fp_digest, rl.fp_tail_seqs, rl.fp_tail_digests,
            rl.fp_tail_descs)
        wires[side] = raw
    assert wires["port"] == wires["ref"]
    assert port_msg.RequestList.from_bytes(
        port_msg.RequestList().to_bytes()).fp_tail_seqs == []


@pytest.mark.parametrize("case", ["renamed", "reshaped", "same"])
def test_coordinator_check_gives_the_reference_error(tmp_path, monkeypatch,
                                                     case):
    """The coordinator's ``_check_fingerprints`` on the gathered lists:
    the same structured ERROR (names and text), and a flight record and
    dump whose tail is the divergence."""
    monkeypatch.setenv("HOROVOD_FLIGHT", "1")
    out = {}
    for side, ctl, tq, flight in (("port", port_ctl, port_tq, port_flight),
                                  ("ref", ref_ctl, ref_tq, ref_flight)):
        monkeypatch.setenv("HOROVOD_FLIGHT_FILE",
                           str(tmp_path / f"{side}.json"))
        rec = flight.configure(0)
        c = ctl.Controller(rank=0, size=2, transport=ctl.LocalTransport(),
                           tensor_queue=tq.TensorQueue(),
                           fingerprint=SIDES[side][0].FingerprintTracker(
                               "strict"))
        trackers = _trackers(side, STREAMS[case])
        gathered = [_fp_list(side, r, t, []) for r, t in
                    enumerate(trackers)]
        resp = c._check_fingerprints(gathered)
        tail = rec.snapshot()[-1:] if rec.dumps else []
        out[side] = (None if resp is None else
                     (resp.response_type.name, resp.tensor_names,
                      resp.error_message),
                     [(e["kind"], e["detail"]) for e in tail], rec.dumps)
    monkeypatch.setenv("HOROVOD_FLIGHT", "0")
    port_flight.configure(0)
    ref_flight.configure(0)
    assert out["port"] == out["ref"]
    if case == "same":
        assert out["port"] == (None, [], 0)
    else:
        assert out["port"][0][0] == "ERROR" and out["port"][2] == 1
        assert out["port"][1][0][0] == "fingerprint-divergence"
