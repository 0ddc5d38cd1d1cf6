"""The port's mesh stack (``parallel/mesh.py``, ``collectives.py``,
``ring_attention.py``, ``ulysses.py``, ``moe.py``, ``pipeline.py``)
against the JAX package, on the CPU.

The port runs as a gloo world of 4 CPU processes, one torch thread each
(``parallel.world.LocalWorld``, joined through a ``FileStore`` in a
temporary directory); one world serves the whole module and every call
into it waits under its own timeout, after which the world is killed and
the call fails. The rank-side bodies are ``tests/_torch_mesh_ranks.py``.
The JAX side runs in this process on ``conftest.py``'s 8 virtual CPU
devices under ``jax.default_matmul_precision("highest")``, on a mesh of
the same shape (the JAX side on the first 4 of its devices). Inputs are numpy arrays from a seed; every
rank returns the global result and each is compared.

Tolerances: ring and Ulysses attention 2e-5 forward and gradients (the
reference's forward tolerance); ring-flash through the plain flash twins
against the JAX ring-flash (its Pallas kernels interpreted) 2e-5 forward,
gradients rtol 5e-4 / atol 5e-5 as ``test_ring_flash_attention_matches_
full``; sharded MoE 1e-5; gpipe 1e-5; collectives' gradients 1e-6; the
Megatron layers against the whole MLP in numpy 1e-5.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as JP

from incubator_mxnet_tpu.parallel import moe as jmoe
from incubator_mxnet_tpu.parallel import ring_attention as jra
from incubator_mxnet_tpu.parallel import ulysses as jul
from incubator_mxnet_tpu.parallel.mesh import shard_map as jshard_map
from incubator_mxnet_tpu.parallel.pipeline import gpipe as jgpipe
from incubator_mxnet_tpu_torch.parallel import mesh as tmesh
from incubator_mxnet_tpu_torch.parallel import tp as ttp
from incubator_mxnet_tpu_torch.parallel.world import LocalWorld

import _torch_mesh_ranks as R

FULL = ("data", "fsdp", "tensor", "pipe", "expert", "seq")


class _World:
    """A LocalWorld of n ranks, remade if a failed call stopped it."""

    def __init__(self, n, root):
        self.n, self.root, self.w, self.k = n, str(root), None, 0

    def _live(self):
        if self.w is None or self.w.closed:
            self.k += 1
            self.w = LocalWorld(self.n, os.path.join(self.root, f"w{self.k}"))
        return self.w

    def start(self, fn, *args, timeout=120):
        """Send the call and return; the JAX side runs meanwhile."""
        self._live().start(fn, *args, timeout=timeout)

    def wait(self):
        return self.w.wait()

    def run(self, fn, *args, timeout=120):
        return self._live().run(fn, *args, timeout=timeout)

    def close(self):
        if self.w is not None:
            self.w.close()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _World(4, tmp_path_factory.mktemp("mesh_world"))
    yield w
    w.close()


def _jmesh(shape, names=FULL):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _qkv(seed, B, T, H, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


def _jax_attention(fn, mesh, q, k, v, causal):
    def loss(q, k, v):
        out = fn(q, k, v, mesh=mesh, causal=causal)
        return jnp.sum(out ** 2), out
    with jax.default_matmul_precision("highest"):
        (_, out), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(out)] + [np.asarray(x) for x in g]


def _close_all(results, want, **tol):
    for r in results:
        for got, w in zip(r, want):
            np.testing.assert_allclose(got, w, **tol)


def test_mesh_config_resolve():
    sizes = tmesh.MeshConfig(data=-1, tensor=2).resolve(8)
    assert sizes["data"] == 4 and sizes["tensor"] == 2
    with pytest.raises(ValueError, match="only one axis"):
        tmesh.MeshConfig(data=-1, tensor=-1).resolve(8)
    with pytest.raises(ValueError, match="axis product"):
        tmesh.MeshConfig(data=2, tensor=2).resolve(8)


def test_mesh_layout_blocks_and_groups(world):
    shape, names = (2, 2), ("data", "seq")
    x = np.arange(32).reshape(8, 4)
    for r, got in enumerate(world.run(R.mesh_layout, shape, names)):
        d, s = np.unravel_index(r, shape)
        assert got["rank"] == r and got["coords"] == {"data": d, "seq": s}
        assert got["block"] == x[4 * d:4 * d + 4, 2 * s:2 * s + 2].tolist()
        assert got["rows"] == x[2 * (2 * d + s):2 * (2 * d + s) + 2].tolist()
        assert got["data_spec"] == tmesh.P("data")
        assert got["uneven"] is None
        assert got["group"]["data"] == [s, 2 + s]
        assert got["group"]["seq"] == [2 * d, 2 * d + 1]
        assert got["replicate"] == x.tolist()
        assert got["remesh"] == {"data": 2, "seq": 2}


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(world, causal):
    q, k, v = _qkv(0, 2, 32, 4, 8)
    want = _jax_attention(jra.ring_attention_sharded,
                          _jmesh((1, 1, 1, 1, 1, 4)), q, k, v, causal)
    got = world.run(R.attention, "ring", (1, 1, 1, 1, 1, 4), FULL, q, k, v,
                    causal)
    _close_all(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_matches_jax(world, causal):
    q, k, v = _qkv(0, 2, 128, 4, 32)
    want = _jax_attention(jra.ring_flash_attention_sharded,
                          Mesh(np.asarray(jax.devices()[:4]), ("seq",)),
                          q, k, v, causal)
    got = world.run(R.attention, "ring_flash", (4,), ("seq",), q, k, v,
                    causal)
    for r in got:
        np.testing.assert_allclose(r[0], want[0], rtol=2e-5, atol=2e-5)
        for name, a, b in zip("qkv", r[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5,
                                       err_msg=f"d{name} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(world, causal):
    q, k, v = _qkv(2, 2, 32, 8, 16)
    want = _jax_attention(jul.ulysses_attention_sharded,
                          _jmesh((1, 1, 1, 1, 1, 4)), q, k, v, causal)
    got = world.run(R.attention, "ulysses", (1, 1, 1, 1, 1, 4), FULL, q, k,
                    v, causal)
    _close_all(got, want, rtol=2e-5, atol=2e-5)


def test_ulysses_head_check(world):
    q = np.random.RandomState(3).randn(1, 16, 3, 8).astype(np.float32)
    for msg in world.run(R.ulysses_heads, (1, 1, 1, 1, 1, 4), FULL, q):
        assert msg is not None and "divisible" in msg


def _moe_inputs():
    rs = np.random.RandomState(0)
    E, d, h = 4, 16, 32
    return (rs.randn(32, d).astype(np.float32),
            rs.randn(d, E).astype(np.float32),
            rs.randn(E, d, h).astype(np.float32),
            np.zeros((E, h), np.float32),
            rs.randn(E, h, d).astype(np.float32),
            np.zeros((E, d), np.float32))


def test_moe_sharded_matches_dense_at_full_capacity(world):
    args = _moe_inputs()
    with jax.default_matmul_precision("highest"):
        yd, _ = jmoe.moe_layer_dense(*args, capacity_factor=8.0)
    for y, aux, _, _ in world.run(R.moe, (2, 1, 1, 1, 2, 1), *args, 8.0):
        np.testing.assert_allclose(y, np.asarray(yd), rtol=1e-5, atol=1e-5)
        assert np.isfinite(aux)


def test_moe_sharded_grads_match_jax(world):
    args = _moe_inputs()
    mesh = _jmesh((2, 1, 1, 1, 2, 1))
    x, gw, w1, b1, w2, b2 = args

    def loss(x, w1):
        y, aux = jmoe.moe_layer_sharded(x, gw, w1, b1, w2, b2, mesh=mesh)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    with jax.default_matmul_precision("highest"):
        (_, (y, aux)), (gx, gw1) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(x, w1)
    for ty, taux, tgx, tgw1 in world.run(R.moe, (2, 1, 1, 1, 2, 1), *args,
                                         1.25):
        np.testing.assert_allclose(ty, np.asarray(y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(taux, float(aux), rtol=1e-5)
        np.testing.assert_allclose(tgx, np.asarray(gx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tgw1, np.asarray(gw1), rtol=1e-5,
                                   atol=1e-5)


def test_gpipe_matches_jax_and_sequential(world):
    n, d = 4, 8
    rs = np.random.RandomState(0)
    st = {"w": (rs.randn(n, d, d) * 0.3).astype(np.float32),
          "b": (rs.randn(n, d) * 0.1).astype(np.float32)}
    x = rs.randn(16, d).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("pipe",))

    def f(w, b, xx):
        out = jgpipe(lambda p, a: jnp.tanh(a @ p["w"] + p["b"]),
                     {"w": w, "b": b}, xx, n_micro=n, mesh=mesh)
        return (out ** 2).sum(), out

    with jax.default_matmul_precision("highest"):
        (_, out), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(st["w"], st["b"], x)
    seq = x.astype(np.float64)
    for i in range(n):
        seq = np.tanh(seq @ st["w"][i] + st["b"][i])
    for t_out, t_grads in world.run(R.gpipe_toy, n, st, x):
        np.testing.assert_allclose(t_out, seq, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_out, np.asarray(out), rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(t_grads, grads):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


_JAX_BODIES = {
    "psum": (lambda a, n: lax.psum(a, "seq"), JP()),
    "pmean": (lambda a, n: lax.pmean(a, "seq"), JP()),
    "all_gather": (lambda a, n: lax.all_gather(a, "seq", axis=0,
                                               tiled=True), JP()),
    "all_gather_1": (lambda a, n: lax.all_gather(a, "seq", axis=1,
                                                 tiled=True), JP()),
    "all_gather_stack": (lambda a, n: lax.all_gather(a, "seq", axis=0),
                         JP()),
    "reduce_scatter": (lambda a, n: lax.psum_scatter(
        a, "seq", scatter_dimension=0, tiled=True), JP("seq")),
    "ppermute": (lambda a, n: lax.ppermute(
        a, "seq", [(i, (i + 1) % n) for i in range(n)]), JP("seq")),
    "ppermute_partial": (lambda a, n: lax.ppermute(
        a, "seq", [(i, i + 1) for i in range(n - 1)]), JP("seq")),
    "all_to_all": (lambda a, n: lax.all_to_all(a, "seq", 1, 0, tiled=True),
                   JP("seq")),
}


@pytest.mark.parametrize("op", sorted(_JAX_BODIES))
def test_collective_gradient_is_the_jax_transpose(world, op):
    n = 4
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    body, out_spec = _JAX_BODIES[op]
    fn = jax.jit(jshard_map(lambda a: body(jnp.tanh(a), n), mesh=mesh,
                            in_specs=(JP("seq"),), out_specs=out_spec,
                            check_vma=False))
    rs = np.random.RandomState(1)
    x = rs.randn(32, 16).astype(np.float32)
    out = np.asarray(fn(x))
    w = rs.randn(*out.shape).astype(np.float32)
    g = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(fn(a) * w)))(x))
    for t_out, t_g in world.run(R.collective_grad, op, n, x, w):
        np.testing.assert_allclose(t_out, out, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t_g, g, rtol=1e-6, atol=1e-6)


def test_megatron_mlp_matches_the_whole_mlp(world):
    """Column- then row-parallel Dense over tensor 2 equal the whole MLP;
    under Megatron's region operators every rank holds the whole input
    gradient and its own slices of the weight gradients (1e-5)."""
    rs = np.random.RandomState(6)
    x = rs.randn(4, 6).astype(np.float32)
    w1, b1 = rs.randn(8, 6).astype(np.float32), rs.randn(8).astype(
        np.float32)
    w2, b2 = rs.randn(5, 8).astype(np.float32), rs.randn(5).astype(
        np.float32)
    h = np.maximum(x @ w1.T + b1, 0)
    y = h @ w2.T + b2
    dy = 2 * y
    dh = (dy @ w2) * (h > 0)
    want = (y, dh @ w1, dh.T @ x, dy.T @ h, dy.sum(0))
    for r, got in enumerate(world.run(R.megatron_mlp, (2, 2), x, w1, b1,
                                      w2, b2)):
        t = r % 2
        for a, b in zip(got, (want[0], want[1], want[2][4 * t:4 * t + 4],
                              want[3][:, 4 * t:4 * t + 4], want[4])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    specs = ttp.megatron_mlp_specs(["ffn1_weight", "ffn2_weight",
                                    "ln_gamma"])
    assert specs == {"ffn1_weight": tmesh.P("tensor", None),
                     "ffn2_weight": tmesh.P(None, "tensor"),
                     "ln_gamma": tmesh.P()}
