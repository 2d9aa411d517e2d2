"""The port's dp x tp layout against ``calfkit_tpu.inference.sharding`` and
``distributed``.

- shard trees: every leaf's spec equals the reference's ``PartitionSpec``
  for the debug, tinyllama and llama-3-8b presets at every mesh of the
  8-device virtual CPU mesh, unquantized and through ``quantize_shardings``
  at 8 and 4 bits, and the caches', pool's and batch's;
- shards: each rank's slice of every debug leaf (f32, int8, int4) is bit
  for bit the reference's ``addressable_shards`` on that rank's device;
- the forward: the port's sharded forward in 8 gloo processes (tp=8,
  tp=4 x dp=2, tp=2 x dp=4) equals the JAX sharded forward in f32 at
  ``atol=1e-4`` (the ranks' partial sums add in another order);
- multi-host: the twin of ``tests/test_distributed.py`` (the unit cases,
  and two processes joined through the environment's coordinates).
"""

import os
import subprocess
import sys
import textwrap

from datetime import timedelta

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from calfkit_tpu.inference import model as JM  # noqa: E402
from calfkit_tpu.inference import quant as JQ  # noqa: E402
from calfkit_tpu.inference import sharding as JS  # noqa: E402
from calfkit_tpu.inference.config import preset as jax_preset  # noqa: E402
from calfkit_tpu_torch.inference import distributed as D  # noqa: E402
from calfkit_tpu_torch.inference import quant as Q  # noqa: E402
from calfkit_tpu_torch.inference import sharding as S  # noqa: E402
from calfkit_tpu_torch.inference.config import preset  # noqa: E402
from tests._torch_port import jax_params, n, quantized_params, torch_params  # noqa: E402
from tests._torch_ranks import run_ranks, sharded_forwards  # noqa: E402

PRESETS = ("debug", "tinyllama-1.1b", "llama-3-8b")
MESHES = [(1, 1), (2, 1), (4, 1), (8, 1), (1, 2), (2, 2), (4, 2)]  # (tp, dp), tp*dp <= 8


def _specs(tree):
    """{path: spec tuple} of a sharding tree (either package's)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (NamedSharding, S.Sharding))
    )[0]:
        spec = tuple(leaf.spec)
        out[jax.tree_util.keystr(path)] = spec + (None,) * (5 - len(spec))
    return out


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("tp,dp", MESHES)
@pytest.mark.parametrize("name", PRESETS)
def test_shard_trees_match_reference(name, tp, dp, bits):
    jcfg, cfg = jax_preset(name), preset(name)
    jmesh, mesh = JS.make_mesh(tp=tp, dp=dp), S.make_mesh(tp=tp, dp=dp, device_type="cpu")
    ref, port = JS.param_shardings(jcfg, jmesh), S.param_shardings(cfg, mesh)
    if bits is not None:
        ref, port = JQ.quantize_shardings(ref, bits=bits), Q.quantize_shardings(port, bits=bits)
        if bits == 4:
            keys = S.q4_template(cfg)
            ref = JQ.align_quant_sharding_keys(ref, keys)
            port = Q.align_quant_sharding_keys(port, keys)
    assert _specs(port) == _specs(ref)
    for B in (4, 6):
        assert S.cache_sharding(cfg, mesh, B).spec == tuple(JS.cache_sharding(jcfg, jmesh, B).spec)
        assert S.batch_sharding(mesh, B).spec == tuple(JS.batch_sharding(jmesh, B).spec)
    assert S.pool_sharding(cfg, mesh).spec == tuple(JS.pool_sharding(jcfg, jmesh).spec)
    assert S.replicated(mesh).spec == tuple(JS.replicated(jmesh).spec)


def test_make_mesh_refuses_as_the_reference():
    with pytest.raises(ValueError, match="mesh needs 8 devices"):
        S.make_mesh(tp=4, dp=2, devices=[0, 1, 2])
    with pytest.raises(ValueError, match="mesh needs 8 devices"):
        JS.make_mesh(tp=4, dp=2, devices=jax.devices()[:3])
    mesh = S.make_mesh(tp=2, dp=2, device_type="cpu")
    assert mesh.ranks.tolist() == [[0, 1], [2, 3]] and mesh.coords(3) == {"dp": 1, "tp": 1}


def _flat(tree):
    # a RankShard is a dict subclass, which jax's tree does not open
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(dict(tree))[0]}


@pytest.mark.parametrize("tp,dp", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_rank_shards_are_the_references_addressable_shards(kind, tp, dp):
    jcfg, cfg = jax_preset("debug"), preset("debug")
    if kind == "f32":
        jp = jax_params()
        tpp = torch_params(jp)
    else:
        jp, tpp = quantized_params(8 if kind == "int8" else 4)
    jmesh, mesh = JS.make_mesh(tp=tp, dp=dp), S.make_mesh(tp=tp, dp=dp, device_type="cpu")
    jsh, sh = JS.param_shardings(jcfg, jmesh), S.param_shardings(cfg, mesh)
    if kind != "f32":
        bits = 8 if kind == "int8" else 4
        jsh, sh = JQ.quantize_shardings(jsh, bits=bits), Q.quantize_shardings(sh, bits=bits)
        if bits == 4:
            jsh, sh = JQ.align_quant_sharding_keys(jsh, jp), Q.align_quant_sharding_keys(sh, tpp)
    placed = _flat(JS.place_params(jp, jsh))
    devices = jmesh.devices  # [dp, tp], as the port's ranks
    for rank in range(tp * dp):
        coords = mesh.coords(rank)
        device = devices[coords["dp"], coords["tp"]]
        mine = _flat(S.place_params(tpp, sh, rank=rank))
        assert mine.keys() == placed.keys()
        for path, arr in placed.items():
            shard = next(s for s in arr.addressable_shards if s.device == device)
            np.testing.assert_array_equal(n(mine[path]), n(shard.data), err_msg=path)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("tp,dp", [(2, 1), (4, 1), (8, 1), (2, 2)])
def test_seeded_rank_shards_cut_one_model(tp, dp, tie):
    """``model.init_params(shardings=, rank=)``: each rank, seeded alike,
    draws bit for bit its :func:`place_params` shard of the whole model
    the same seed draws."""
    from calfkit_tpu_torch.inference import model as M

    cfg = preset("debug", dtype="float32", tie_embeddings=tie)
    mesh = S.make_mesh(tp=tp, dp=dp, device_type="cpu")
    shardings = S.param_shardings(cfg, mesh)
    full = M.init_params(cfg, torch.Generator().manual_seed(7))
    for rank in range(mesh.size):
        mine = _flat(M.init_params(cfg, torch.Generator().manual_seed(7), shardings=shardings,
                                   rank=rank))
        want = _flat(S.place_params(full, shardings, rank=rank))
        assert mine.keys() == want.keys()
        for path, leaf in want.items():
            assert torch.equal(mine[path], leaf), (rank, path)


def test_layout_reads_the_shard_tree():
    """A rank's layout splits a product's reduction only where the specs
    split it: llama-3-8b at tp=8 splits heads (wo), ff (w_down) and vocab;
    debug at tp=8 (H = 4) replicates the attention, splits the MLP and
    vocab; a vocab that does not divide stays whole."""
    for name, tp, want in [("llama-3-8b", 8, (True, True, True, (0, 1))),
                           ("debug", 8, (False, True, True, (0, 2))),
                           ("debug", 2, (True, True, True, (0, 1)))]:
        cfg = preset(name)
        lay = S.layout_of(cfg, S.make_mesh(tp=tp, device_type="cpu"), 0)
        specs = S.param_shardings(cfg, S.make_mesh(tp=tp, device_type="cpu"))["layers"]
        assert (lay.heads, lay.ff, lay.vocab is not None, lay.kv) == want, name
        assert lay.heads == (specs["wo"].spec[1] == "tp")
    odd = S.layout_of(preset("debug", vocab_size=510), S.make_mesh(tp=4, device_type="cpu"), 1)
    assert odd.vocab is None and odd.ff


def test_int4_alignment_refused_where_a_rank_cuts_a_group():
    """A tp split of w_down's packed F must give each rank whole groups of
    the scale, or rows inside one group; anything else raises."""
    mesh = S.make_mesh(tp=4, device_type="cpu")
    S.check_q4_alignment(preset("llama-3-8b"), mesh)  # 3584 = 28 groups
    S.check_q4_alignment(preset("debug"), mesh)  # 32 rows inside one
    with pytest.raises(ValueError, match="int4 at tp=4"):
        S.check_q4_alignment(preset("debug", d_ff=384), mesh)


def test_sharded_forward_matches_reference():
    """The twin of ``tests/test_inference.py``'s sharded forward: the
    port's ranks (gloo processes) against the JAX forward on the same
    meshes, f32."""
    jcfg = jax_preset("debug", dtype="float32")
    params = jax_params()
    B, T = 2, 8
    tokens = np.asarray(jax.random.randint(jax.random.key(3), (B, T), 3, jcfg.vocab_size))
    meshes = [(8, 1), (4, 2), (2, 4)]
    refs = []
    for tp, dp in meshes:
        jmesh = JS.make_mesh(tp=tp, dp=dp)
        placed = JS.place_params(params, JS.param_shardings(jcfg, jmesh))
        cache = JM.make_empty_cache(jcfg, B, 16, dtype=jnp.float32)
        out, _ = jax.jit(JM.forward, static_argnums=1)(
            placed, jcfg, jnp.asarray(tokens), jnp.broadcast_to(jnp.arange(T), (B, T)), cache,
            jnp.full((B,), T))
        refs.append(np.asarray(out))
    ranks = run_ranks(8, sharded_forwards, meshes, jax.tree.map(np.asarray, params),
                      tokens.astype(np.int64))
    for rank, outs in enumerate(ranks):
        for (tp, dp), out, ref in zip(meshes, outs, refs):
            np.testing.assert_allclose(out, ref, atol=1e-4, err_msg=f"rank {rank} tp={tp} dp={dp}")


# --------------------------------------------------------------------------- #
# multi-host bring-up: the twin of tests/test_distributed.py
# --------------------------------------------------------------------------- #


class TestSingleHost:
    def test_noop_without_coordinates(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        info = D.initialize_multihost()
        assert info.num_processes == 1
        assert info.process_id == 0
        assert not info.is_multihost
        assert info.global_devices == info.local_devices


class TestMeshFit:
    def _info(self, **kw):
        defaults = dict(process_id=0, num_processes=2, local_devices=4, global_devices=8)
        defaults.update(kw)
        return D.MultihostInfo(**defaults)

    def test_fits(self):
        D.assert_engine_fits(self._info(), tp=4, dp=2)

    def test_over_ask_rejected(self):
        with pytest.raises(ValueError, match="needs 16 devices"):
            D.assert_engine_fits(self._info(), tp=8, dp=2)

    def test_multihost_partial_mesh_rejected(self):
        with pytest.raises(ValueError, match="span the whole pod"):
            D.assert_engine_fits(self._info(), tp=2, dp=1)

    def test_single_host_partial_mesh_allowed(self):
        info = self._info(num_processes=1, global_devices=8, local_devices=8)
        D.assert_engine_fits(info, tp=2, dp=1)

    def test_partial_coordinates_rejected_loudly(self):
        with pytest.raises(ValueError, match="set together"):
            D.initialize_multihost(process_id=0)

    def test_single_host_message_names_host(self):
        info = self._info(num_processes=1, global_devices=4, local_devices=4)
        with pytest.raises(ValueError, match="host has 4"):
            D.assert_engine_fits(info, tp=8, dp=1)

    def test_nccl_needs_cards(self, tmp_path):
        """NCCL where there is no card raises before any rank waits."""
        if D.torch.cuda.is_available():
            pytest.skip("this host has a card")
        with pytest.raises(ValueError, match="nccl"):
            D.init_group("file://" + str(tmp_path / "store"), 1, 0, backend="nccl")


_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    from calfkit_tpu_torch.inference.distributed import initialize_multihost

    info = initialize_multihost()
    assert info.num_processes == 2 and info.is_multihost, info
    x = torch.arange(4, dtype=torch.float32) + 4 * info.process_id
    dist.all_reduce(x)
    print(f"RESULT {{info.process_id}} {{info.global_devices}} {{float(x.sum())}}")
    dist.destroy_process_group()
""")


def test_descriptor_channel_frees_what_it_deletes():
    """The spawned group's store is a TCP store that rank 0 hosts, where
    the channel's deletes free the keys: over three times ``KEEP``
    descriptors, each received as it is sent, the store holds ``KEEP``."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, 1, True, timedelta(seconds=30),
                          wait_for_workers=False)
    sender, receiver = D.Channel(store, "engine", 0, 2), D.Channel(store, "engine", 1, 2)
    for i in range(3 * D.Channel.KEEP):
        sender.send(("fill", "x", np.full(64, i)))
        assert receiver.recv()[2][0] == i
    assert store.num_keys() == D.Channel.KEEP


def test_two_processes_through_env_coordinates(tmp_path):
    """Two REAL processes join through ``CALFKIT_COORDINATOR`` (a
    ``file://`` store under ``tmp_path``), ``CALFKIT_NUM_PROCESSES`` and
    ``CALFKIT_PROCESS_ID``: each sees both ranks and the same sum."""
    script = tmp_path / "child.py"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script.write_text(_CHILD.format(repo=repo))
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, CALFKIT_COORDINATOR="file://" + str(tmp_path / "store"),
                   CALFKIT_NUM_PROCESSES="2", CALFKIT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-800:]
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    results = sorted(line.split()[1:] for out in outs for line in out.splitlines()
                     if line.startswith("RESULT"))
    assert results == [["0", "2", "28.0"], ["1", "2", "28.0"]]
