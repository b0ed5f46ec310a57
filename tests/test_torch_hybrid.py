"""The port's launch over several hosts against JAX's hybrid mesh
(``make_hybrid_mesh``: dp over hosts, each tp row inside one host) on the
CPU: the rank grid of ``parallel.hybrid_rank_grid`` equals
``make_hybrid_mesh``'s device order in both of ``tests/test_tp_parity.py``'s
hybrid cases (and with the hosts interleaved), and raises where JAX
asserts; the factory's plan (``plan_hybrid_mesh``) is the JAX branch's; the
CLI and the server hand the node arguments to the launch. Two
``launch(nodes=2)`` calls of two gloo CPU ranks each, meeting on a
``TCPStore`` at 127.0.0.1 (``tests/_torch_mesh_ranks.py`` ``hybrid_run``, no
JAX), run the tiny CFG denoise on the (2, 1, 2) hybrid mesh against JAX's
``make_hybrid_mesh(tp=2, dp_ici=1)`` run on the same noise (rtol 2e-4 /
atol 2e-5, ``tests/test_tp_parity.py``) and the pipeline's image with the
tiles decoded inside each host; a tp row across the hosts is refused."""

import concurrent.futures
import dataclasses
import os
import re
import socket

import numpy as np
import pytest

import jax

from kandinsky5_tpu.parallel.sharding import make_hybrid_mesh
from kandinsky5_tpu_torch.checkpoint import dit_state_dict_from_jax
from kandinsky5_tpu_torch.parallel import hybrid_rank_grid, launch
from kandinsky5_tpu_torch.parallel.sharding import plan_hybrid_mesh

from . import _torch_mesh_ranks as ranks_mod
from .test_torch_dp import _denoise_cases, _single_pipeline
from .test_torch_pipeline import REPO
from .test_tp_parity import _run, _setup

RTOL, ATOL = 2e-4, 2e-5


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(np.asarray(mesh.devices, object))


@pytest.mark.parametrize("tp,dp_ici,hosts", [
    (4, 1, lambda i: i // 4), (2, 2, lambda i: i // 4),
    (2, 2, lambda i: i % 2)], ids=["tp4", "tp2_dp_ici2", "interleaved"])
def test_hybrid_grid_matches_make_hybrid_mesh(tp, dp_ici, hosts):
    """Row for row, the port's grid of global ranks is JAX's grid of device
    ids over 8 CPU devices with ``host_index_fn = hosts(id)``."""
    want = _ids(make_hybrid_mesh(tp=tp, dp_ici=dp_ici,
                                 host_index_fn=lambda d: hosts(d.id)))
    got = hybrid_rank_grid(tp, dp_ici, [hosts(r) for r in range(8)])
    np.testing.assert_array_equal(got, want)
    for row in got:
        assert len({hosts(r) for r in row}) == 1


def test_hybrid_grid_raises_where_jax_asserts():
    """Uneven ranks per host, or dp_ici x tp unlike a host's ranks."""
    with pytest.raises(AssertionError, match="uneven"):
        make_hybrid_mesh(tp=2, host_index_fn=lambda d: int(d.id < 3))
    with pytest.raises(ValueError, match="uneven"):
        hybrid_rank_grid(2, 1, [int(r < 3) for r in range(8)])
    with pytest.raises(AssertionError, match="dp_ici"):
        make_hybrid_mesh(tp=2, dp_ici=1, host_index_fn=lambda d: d.id // 4)
    with pytest.raises(ValueError, match="dp_ici"):
        hybrid_rank_grid(2, 1, [r // 4 for r in range(8)])


def test_plan_hybrid_mesh_is_the_jax_factory_rule():
    """``get_T2V_pipeline(tp=N)`` over several processes: N the tp width,
    dividing a host's devices, the rest of the host dp_ici, dp over the
    hosts (``kandinsky5_tpu/pipeline.py``)."""
    assert plan_hybrid_mesh(2, 4, 2) == (4, 1, 2)
    assert plan_hybrid_mesh(4, 4, 2) == (2, 1, 4)
    assert plan_hybrid_mesh(2, 2, 2) == (2, 1, 2)
    with pytest.raises(ValueError, match="may not cross hosts"):
        plan_hybrid_mesh(4, 2, 2)


def test_cli_and_server_launch_over_nodes(monkeypatch):
    """``--nnodes 2 --node-rank 1 --master-addr --master-port --tp 2`` on 4
    CPU ranks a node reaches ``launch`` as this node's part of the (4, 1,
    2) hybrid mesh; the server hands it the same. The launches are
    recorded, not run."""
    from kandinsky5_tpu_torch import cli, parallel, serve

    calls = []

    def fake_launch(fn, world, backend, device, args=(), **kw):
        calls.append(dict(fn=fn, world=world, backend=backend,
                          device=device, **kw))
        return [None] * (world // kw["nodes"])

    monkeypatch.setattr(parallel, "launch", fake_launch)
    node = ["--tp", "2", "--device", "cpu", "--nnodes", "2", "--node-rank",
            "1", "--nproc-per-node", "4", "--master-addr", "10.0.0.1",
            "--master-port", "29511"]
    cli.main(node)
    serve.main(["--config", "x.yaml"] + node)
    want = dict(world=8, backend="gloo", device="cpu", dp=4, sp=1, nodes=2,
                node_rank=1, master=("10.0.0.1", 29511))
    assert calls[0] == dict(want, fn=cli.generate)
    assert calls[1] == dict(want, fn=serve.serve_rank, timeout=None)
    with pytest.raises(ValueError, match="master"):
        cli.main(node[:-4])
    # on the card a host runs one rank a card: no count is taken
    with pytest.raises(ValueError, match="nproc-per-node"):
        cli.main([a if a != "cpu" else "cuda" for a in node])


def test_port_reads_no_environment():
    """No module of the port and not chip_smoke.py reads an environment
    variable: a node's rank, the world size and the master's address come
    in as arguments."""
    pattern = re.compile(r"os\.environ|getenv|environ\[")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "kandinsky5_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            bad += [f"{os.path.relpath(path, REPO)}:{i + 1}"
                    for i, line in enumerate(f) if pattern.search(line)]
    assert not bad, bad


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_hosts():
    """Two node launches of two ranks each on 127.0.0.1, and JAX's hybrid
    run computed while they run."""
    cfg, params, noise, cond, uncond = _setup()
    tiny = (dataclasses.asdict(cfg),
            dit_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    work = dict(dit=tiny, case=_denoise_cases()["cfg"])
    master = ("127.0.0.1", _free_port())
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(launch, ranks_mod.hybrid_run, 4, "gloo", "cpu",
                               args=(work,), timeout=300, dp=2, nodes=2,
                               node_rank=h, master=master)
                   for h in range(2)]
        mesh = make_hybrid_mesh(tp=2, dp_ici=1, devices=jax.devices()[:4],
                                host_index_fn=lambda d: d.id // 2)
        want = _run(cfg, params, noise, cond, uncond, mesh=mesh)
        single = _single_pipeline()
        got = [r for f in futures for r in f.result()]
    return got, want, single


def test_two_host_launch_lays_out_the_hybrid_mesh(two_hosts):
    """Global rank = node x 2 + local index; each tp row is one host's two
    ranks, dp pairs the hosts, and each rank's host group is its node."""
    got, _, _ = two_hosts
    assert [r["rank"] for r in got] == [0, 1, 2, 3]
    for r in got:
        h = r["rank"] // 2
        assert r["shape"] == (2, 1, 2) and r["host"] == h
        assert r["tp_ranks"] == r["local_ranks"] == [2 * h, 2 * h + 1]
        assert r["dp_ranks"] == [r["rank"] % 2, r["rank"] % 2 + 2]


def test_two_host_denoise_matches_jax_hybrid(two_hosts):
    """The CFG pair split over the hosts' dp, each host's tp pair holding
    half the heads: every rank's latents equal, within rtol 2e-4 / atol
    2e-5 of JAX's ``make_hybrid_mesh(tp=2, dp_ici=1)`` run."""
    got, want, _ = two_hosts
    for r in got:
        np.testing.assert_array_equal(r["denoise"]["latents"],
                                      got[0]["denoise"]["latents"])
        assert r["denoise"]["gathers"] == 2
    np.testing.assert_allclose(got[0]["denoise"]["latents"], want,
                               rtol=RTOL, atol=ATOL)
    assert not np.allclose(got[0]["denoise"]["no_gather"], want, rtol=RTOL,
                           atol=ATOL)


def test_two_host_pipeline_decodes_inside_each_host(two_hosts):
    """The pipeline's 64 x 64 image in 3 x 3 tiles: each host's two ranks
    split all 9 tiles (5 and 4), never the four ranks together (3, 3, 3,
    0); rank 0's frames equal the one-device tiled pipeline's."""
    got, _, single = two_hosts
    assert [r["pipeline"]["decoded_tiles"] for r in got] == [5, 4, 5, 4]
    np.testing.assert_array_equal(got[0]["pipeline"]["frames"], single)
    assert all(r["pipeline"]["frames"] is None for r in got[1:])


def test_a_tp_row_across_hosts_is_refused():
    """A launch whose tp rows would cross the hosts (tp 4 over two hosts
    of two ranks) raises before any rank starts."""
    with pytest.raises(ValueError, match="may not cross hosts"):
        launch(ranks_mod.hybrid_run, 4, "gloo", "cpu", args=({},), dp=1,
               nodes=2, node_rank=0, master=("127.0.0.1", 1))
