"""The port's collectives, topology and comms logger, on gloo ranks.

Four ranks on a ``{data: 2, fsdp: 2}`` mesh: ``all_reduce`` (sum, mean,
max over one axis and over both), ``all_gather`` and ``reduce_scatter``
along dims 0 and 1, ``broadcast`` and the host collectives, each held to
numpy on the same per-rank inputs; the comms logger's rows (calls, bytes,
ranks) after them, and ``calc_bw_log`` against the JAX package's formula.
In this process: the topology's sizes, coordinates and batch slots, and a
mesh that does not make up the world raising the JAX builder's
``ValueError``.
"""

import numpy as np
import pytest

from deepspeed_tpu.utils.comms_logging import calc_bw_log as jax_calc_bw_log
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.topology import MeshTopology, reset_topology
from deepspeed_tpu_torch.config.config import MeshConfig
from deepspeed_tpu_torch.utils.comms_logging import calc_bw_log
from torch_dist_common import RankPool
from torch_ragged_common import shared

MESH = {"data": 2, "fsdp": 2}
SHAPE = (4, 6)


def rank_input(rank: int) -> np.ndarray:
    return np.random.default_rng(rank).normal(size=SHAPE).astype(np.float32)


def coords(rank: int) -> tuple[int, int]:
    return divmod(rank, MESH["fsdp"])   # (data, fsdp): fsdp varies fastest


def collectives() -> dict:
    """Runs on the ranks."""
    import torch

    from deepspeed_tpu_torch.config.config import CommsLoggerConfig
    from deepspeed_tpu_torch.utils.comms_logging import COMMS_LOGGER

    reset_topology()
    topo = comm.init_distributed(MeshConfig(**MESH))
    COMMS_LOGGER.reset()
    comm.configure(CommsLoggerConfig(enabled=True))
    x = torch.from_numpy(rank_input(topo.rank))
    out = {"rank": topo.rank, "coords": (topo.coord("data"), topo.coord("fsdp")),
           "batch_index": topo.batch_index()}
    for axis in ("data", "fsdp", ("data", "fsdp")):
        for op in ("sum", "mean", "max"):
            out[("all_reduce", axis, op)] = comm.all_reduce(x.clone(), axis, op).numpy()
    for dim in (0, 1):
        out[("all_gather", dim)] = comm.all_gather(x, "fsdp", gather_dim=dim).numpy()
        out[("reduce_scatter", dim)] = comm.reduce_scatter(x, "data", scatter_dim=dim).numpy()
    out["broadcast"] = comm.broadcast(x.clone(), "fsdp", src_index=1).numpy()
    out["host_allgather"] = comm.host_allgather(np.asarray([topo.rank]))
    out["host_broadcast"] = comm.host_broadcast(np.asarray([10 + topo.rank]))
    comm.barrier()
    out["rows"] = COMMS_LOGGER.rows()
    out["summary"] = comm.log_summary(show_straggler=True)
    comm.configure(CommsLoggerConfig(enabled=False))
    COMMS_LOGGER.reset()
    return out


def _run_collectives() -> list:
    pool = RankPool(4)
    try:
        return pool.run(collectives)
    finally:
        pool.close()


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, computed once a test run."""
    return shared(_run_collectives)


def peers(axis, rank):
    """Ranks sharing every coordinate but ``axis``'s, in axis order."""
    d, f = coords(rank)
    if axis == "data":
        return [r for r in range(4) if coords(r)[1] == f]
    if axis == "fsdp":
        return [r for r in range(4) if coords(r)[0] == d]
    return list(range(4))


def test_coords_and_batch_slots(ranks):
    assert [r["coords"] for r in ranks] == [coords(r) for r in range(4)]
    assert [r["batch_index"] for r in ranks] == [0, 1, 2, 3]


@pytest.mark.parametrize("axis", ["data", "fsdp", ("data", "fsdp")], ids=str)
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_all_reduce(ranks, axis, op):
    for r in ranks:
        xs = np.stack([rank_input(p) for p in peers(axis, r["rank"])])
        want = {"sum": xs.sum(0), "mean": xs.mean(0), "max": xs.max(0)}[op]
        np.testing.assert_allclose(r[("all_reduce", axis, op)], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_and_reduce_scatter(ranks, dim):
    for r in ranks:
        gathered = np.concatenate([rank_input(p) for p in peers("fsdp", r["rank"])], axis=dim)
        np.testing.assert_array_equal(r[("all_gather", dim)], gathered)
        total = sum(rank_input(p) for p in peers("data", r["rank"]))
        block = np.split(total, 2, axis=dim)[coords(r["rank"])[0]]
        np.testing.assert_allclose(r[("reduce_scatter", dim)], block, rtol=1e-6, atol=1e-6)


def test_broadcast_and_host_collectives(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["broadcast"], rank_input(peers("fsdp", r["rank"])[1]))
        np.testing.assert_array_equal(r["host_allgather"], np.arange(4)[:, None])
        np.testing.assert_array_equal(r["host_broadcast"], [10])


def test_comms_logger_rows(ranks):
    nbytes = int(np.prod(SHAPE)) * 4
    for r in ranks:
        rows = r["rows"]
        assert rows["all_reduce"]["calls"] == 9
        assert rows["all_reduce"]["bytes"] == 9 * nbytes
        assert rows["reduce_scatter"]["calls"] == 2
        assert rows["reduce_scatter"]["bytes"] == 2 * nbytes // 2
        assert rows["reduce_scatter"]["n_ranks"] == 2
        assert rows["broadcast"]["calls"] == 2   # the axis broadcast and the host one
        assert rows["barrier"]["calls"] == 1
        assert all(row["avg_ms"] > 0 for row in rows.values())
        assert "Straggler analysis" in r["summary"]


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                                "broadcast"])
def test_calc_bw_log_is_the_reference_formula(op):
    for size, seconds, n in ((1 << 20, 1e-3, 4), (123, 5e-6, 2), (1 << 30, 0.25, 8)):
        assert calc_bw_log(op, size, seconds, n) == pytest.approx(
            jax_calc_bw_log(op, size, seconds, n), rel=1e-12)


def test_topology_in_one_process():
    topo = MeshTopology.build(MeshConfig(data=-1, fsdp=2), world_size=8, rank=5)
    assert topo.sizes["data"] == 4 and topo.dp_world_size == 8
    assert topo.coords()["data"] == 2 and topo.coord("fsdp") == 1
    assert topo.batch_index() == 5 and topo.describe() == "8 devices as {'data': 4, 'fsdp': 2}"
    with pytest.raises(ValueError, match="Mesh axes product 2 != device count 1"):
        MeshTopology.build(MeshConfig(data=2), world_size=1)
    with pytest.raises(ValueError, match="not divisible by non-data axes product 2"):
        MeshTopology.build(MeshConfig(data=-1, fsdp=2), world_size=3)


def test_one_process_collectives_are_identities():
    import torch

    reset_topology()
    topo = comm.init_distributed(MeshConfig())
    x = torch.arange(6.0).reshape(2, 3)
    assert topo.world_size == 1 and comm.get_world_size() == 1 and comm.get_rank() == 0
    assert comm.all_reduce(x, "data") is x
    assert comm.all_gather(x, "fsdp", gather_dim=1) is x
    assert comm.reduce_scatter(x, ("data", "fsdp")) is x
    reset_topology()
