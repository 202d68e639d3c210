"""The collective audit (parallel/audit.py) of mesh train steps on 2 gloo
ranks (the counterparts of JAX tests/test_collective_audit.py:71-99).

* A data-parallel step all-reduces the gradient's bytes in one bucket,
  the three global scalars (loss, accuracy, squared norm) in one f64
  all-reduce, and each train-mode BatchNorm's sums twice (forward and
  backward); nothing else.
* A ZeRO-3 step all-gathers the sharded leaves once (their shards'
  bytes) and reduce-scatters their gradients once, stays within JAX's
  ZeRO-3 budget (10x the parameters' f32 bytes) and has no all-to-all or
  permute. In bf16 on f32 masters the all-gather moves the compute type
  and the reduce-scatter the master type: one collective of each, of one
  element count, and the second twice the first's bytes.
* The trace reader on a hand-made trace: the ``c10d::*`` ops, their
  element counts, the types from the backend's events, each op's from
  its own event where two ops share a size.
"""

import os
import pickle
import socket

import pytest
import torch

D, C, B, T = 24, 20, 8, 40
SMALL = dict(channels=32, mfa_conv=96, embd_dim=16)


def _net():
    from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet
    from asv_subtools_tpu_torch.weights import init_weights_

    net = SpeakerNet(EcapaTdnn(input_dim=D, device="cpu", **SMALL), "margin_softmax", {"method": "aam", "m": 0.2},
                     num_targets=C)
    return init_weights_(net, 0)


def _audit(fsdp: bool, compute=torch.float32):
    from asv_subtools_tpu_torch.nn.norm import BatchNorm
    from asv_subtools_tpu_torch.parallel import make_fsdp_rules, make_mesh
    from asv_subtools_tpu_torch.parallel.audit import audit_train_step
    from asv_subtools_tpu_torch.train import Trainer, TrainStepConfig, get_optimizer

    mesh = make_mesh(2, 1)
    net = _net()
    trainer = Trainer(net, get_optimizer("adamW", learning_rate=1e-3), device="cpu", mesh=mesh,
                      config=TrainStepConfig(compute_dtype=compute),
                      partition_rules=make_fsdp_rules(mesh, min_size=4096) if fsdp else None)
    g = torch.Generator().manual_seed(0)
    batch = trainer._to_device({"x": torch.randn(B, T, D, generator=g), "y": torch.randint(0, C, (B,), generator=g)})
    state = [trainer.init_state()]

    def run():
        state[0], _ = trainer._train_step(state[0], batch, g)

    audit = audit_train_step(run, steps=2)
    placement = trainer.placement
    return {"collectives": audit.collectives, "counts": audit.counts(), "bytes": audit.bytes_by_op(),
            "total": audit.total_bytes, "table": audit.table(),
            "n_params": sum(p.numel() for p in net.parameters()),
            "bn_channels": [m.mean.numel() for m in net.modules() if isinstance(m, BatchNorm)],
            "shard_elements": sum(state[0].params[k].numel() for k in placement.sharded)}


def _rank_main(rank, world, port, workdir):
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                         rank=rank)
    try:
        out = {"dp": _audit(False), "fsdp": _audit(True), "fsdp_bf16": _audit(True, torch.bfloat16)}
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        with open(os.path.join(workdir, "audit.pkl"), "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def audits(tmp_path_factory):
    import torch.multiprocessing as mp

    workdir = str(tmp_path_factory.mktemp("torch_audit"))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mp.start_processes(_rank_main, args=(2, port, workdir), nprocs=2, join=True, start_method="spawn")
    with open(os.path.join(workdir, "audit.pkl"), "rb") as f:
        return pickle.load(f)


def test_data_parallel_all_reduces_the_gradient_the_scalars_and_the_bn_sums(audits):
    a = audits["dp"]
    bn_bytes = sum(2 * 2 * c * 4 for c in a["bn_channels"])  # [s1, s2] in f32, forward and backward
    assert a["counts"] == {"all-reduce": 1 + 1 + 2 * len(a["bn_channels"])}, a["table"]
    assert a["bytes"]["all-reduce"] == 4 * a["n_params"] + 3 * 8 + bn_bytes, a["table"]
    # the gradient goes in one flat bucket
    buckets = [c for c in a["collectives"] if c["elements"] == a["n_params"]]
    assert len(buckets) == 2 and all(c["op"] == "all-reduce" for c in buckets)


def test_fsdp_step_is_zero3_scale(audits):
    a = audits["fsdp"]
    counts = a["counts"]
    assert counts.get("all-to-all", 0) == 0 and counts.get("collective-permute", 0) == 0, counts
    # one all-gather of every shard at use, one reduce-scatter of their gradients
    assert counts["all-gather"] == 1 and counts["reduce-scatter"] == 1, a["table"]
    assert a["shard_elements"] > a["n_params"] // 4
    assert a["bytes"]["all-gather"] == 4 * a["shard_elements"]
    assert a["bytes"]["reduce-scatter"] == 4 * a["shard_elements"]
    assert a["total"] < 10 * a["n_params"] * 4, a["table"]


def test_fsdp_bf16_step_types_each_collective_from_its_own_event(audits):
    a = audits["fsdp_bf16"]
    assert a["counts"]["all-gather"] == 1 and a["counts"]["reduce-scatter"] == 1, a["table"]
    gather, scatter = (next(c for c in a["collectives"] if c["op"] == op) for op in ("all-gather", "reduce-scatter"))
    assert gather["elements"] == scatter["elements"] == a["shard_elements"]
    assert a["bytes"]["all-gather"] == 2 * a["shard_elements"], a["table"]
    assert a["bytes"]["reduce-scatter"] == 2 * a["bytes"]["all-gather"], a["table"]


def test_audit_trace_reads_the_c10d_ops():
    from asv_subtools_tpu_torch.parallel.audit import audit_trace

    ev = lambda name, ts, types, dims: {"name": name, "ph": "X", "ts": ts,  # noqa: E731
                                        "args": {"Input type": types, "Input Dims": dims}}
    trace = {"traceEvents": [
        ev("c10d::allreduce_", 1, ["TensorList", "", "", "", "Scalar", "Scalar"], [[[1000]], [], [], [], [], []]),
        ev("c10d::allgather_", 2, ["", "TensorList", "", "Scalar", "Scalar"], [[], [[10]], [], [], []]),
        ev("c10d::reduce_scatter_", 3, ["TensorList", "", "", "", "Scalar", "Scalar"],
           [[[7]], [], [], [], [], []]),
        ev("c10d::barrier", 4, [], []),
        ev("gloo:all_reduce", 5, ["float"], [[1000]]),
        ev("gloo:all_gather", 6, ["c10::BFloat16"], [[10]]),
        ev("gloo:all_reduce", 7, ["double"], [[7]]),
    ]}
    a = audit_trace(trace, steps=1)
    assert a.counts() == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
    assert a.bytes_by_op() == {"all-gather": 20, "all-reduce": 4000, "reduce-scatter": 56}
    assert a.total_bytes == 4076 and a.involuntary_remats is None
    assert "| all-reduce | 1 | 0.00 MB |" in a.table()


def test_audit_trace_types_ops_of_one_size_each_from_its_own_event():
    """Two ops of 10 elements, bf16 then f32 (ZeRO-3's pair), and an NCCL
    op whose type comes from its record_param_comms event; a device
    kernel's event is not read."""
    from asv_subtools_tpu_torch.parallel.audit import audit_trace

    ev = lambda name, ts, args, cat="cpu_op": {"name": name, "ph": "X", "ts": ts, "pid": 1, "cat": cat,  # noqa: E731
                                               "args": args}
    c10d = lambda name, ts, n: ev(name, ts, {"Input type": ["TensorList", ""], "Input Dims": [[[n]], []]})  # noqa: E731
    trace = {"traceEvents": [
        c10d("c10d::allgather_", 1, 10),
        ev("gloo:all_gather", 2, {"Input type": ["c10::BFloat16"], "Input Dims": [[10]]}, "user_annotation"),
        ev("ncclDevKernel_AllReduce", 3, {"dtype": "Float", "In msg nelems": 10}, "kernel"),
        c10d("c10d::reduce_scatter_", 4, 10),
        ev("gloo:all_reduce", 5, {"Input type": ["float"], "Input Dims": [[10]]}, "user_annotation"),
        ev("gloo:all_reduce", 6, {"Input type": ["float"], "Input Dims": [[10]]}, "user_annotation"),
        c10d("c10d::allreduce_", 7, 6),
        ev("record_param_comms", 8, {"dtype": "BFloat16", "In msg nelems": 6, "Out msg nelems": 6}),
    ]}
    a = audit_trace(trace, steps=1)
    assert [(c["op"], c["dtype"], c["bytes"]) for c in a.collectives] == [
        ("all-gather", "c10::BFloat16", 20), ("reduce-scatter", "float", 40), ("all-reduce", "BFloat16", 12)]
