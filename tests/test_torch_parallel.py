"""The port's meshes, collectives, ring and Ulysses attention, GPipe
pipeline and Switch MoE (``mxnet_tpu_torch/parallel``) against the JAX
package's on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's side on a CPU mesh (``with mx.cpu():``), where every
position is the one CPU device and the flash kernels take their plain
versions. Both get the same numpy inputs from a seed. Tolerances: the
JAX tests' own — 2e-5 on attention outputs, 1e-4 on their gradients;
pipeline and MoE outputs 2e-4 relative / 2e-5 absolute, their gradients
2e-3 / 2e-4 (the JAX pipeline test's)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu.parallel as JP
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import collectives as C
from mxnet_tpu_torch.parallel import moe as TM
from mxnet_tpu_torch.parallel import build_mesh

OUT_TOL = 2e-5
GRAD_TOL = 1e-4


def _jmesh(axis, n):
    return JP.build_mesh({axis: n}, jax.devices("cpu")[:n])


def _tmesh(axis, n):
    with mx.cpu():
        return build_mesh({axis: n})


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ------------------------------------------------------------------ mesh
def test_cpu_mesh_positions_repeat_the_one_cpu_and_say_so():
    mesh = _tmesh("sp", 4)
    assert mesh.shape == {"sp": 4} and mesh.size == 4
    assert mesh.device_list == [torch.device("cpu")] * 4
    assert mesh.repeated and "devices repeat" in repr(mesh)
    with mx.cpu():
        two = build_mesh({"dp": 2, "tp": -1}, devices=["cpu"] * 4)
    assert two.shape == {"dp": 2, "tp": 2} and not two.repeated
    assert two.groups("tp") == [[0, 1], [2, 3]]
    assert two.groups("dp") == [[0, 2], [1, 3]]
    assert two.coords(3) == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError):
        build_mesh({"sp": 3}, devices=["cpu", "cpu"])


def test_mesh_never_moves_to_the_cpu_unasked(monkeypatch):
    """Outside ``with mx.cpu():`` and without a device list the positions
    fill the cards; with none the mesh raises instead of taking the CPU
    (C15)."""
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        build_mesh({"sp": 4})
    from mxnet_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(M, "_visible_devices",
                        lambda: ([torch.device("cuda", 0)], False))
    one_card = build_mesh({"sp": 4})
    assert one_card.device_list == [torch.device("cuda", 0)] * 4
    assert "cuda:0" in repr(one_card) and one_card.repeated


def test_mesh_takes_jax_device_objects_without_importing_jax():
    """The example scripts pass ``jax.devices()``: any object with
    ``platform`` and ``id`` names a device (cpu, else ``cuda:<id>``)."""

    class Dev:
        def __init__(self, platform, id):
            self.platform, self.id = platform, id

    mesh = build_mesh({"sp": 2}, [Dev("cpu", 0), Dev("cpu", 1)])
    assert mesh.device_list == [torch.device("cpu")] * 2
    gpu = build_mesh({"sp": 2}, [Dev("gpu", 0), Dev("tpu", 1)])
    assert gpu.device_list == [torch.device("cuda", 0), torch.device("cuda", 1)]
    real = build_mesh({"sp": 2}, jax.devices("cpu")[:2])
    assert real.device_list == [torch.device("cpu")] * 2
    ctx = build_mesh({"sp": 2}, [mx.cpu(0), mx.cpu(1)])
    assert ctx.device_list == [torch.device("cpu")] * 2


# ---------------------------------------------------------- collectives
def test_shard_unshard_and_run_sharded():
    mesh = _tmesh("sp", 4)
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    parts = C.shard(x, mesh, C.P(None, "sp"))
    assert [tuple(p.shape) for p in parts] == [(2, 2, 3)] * 4
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(C.unshard(parts, mesh, C.P(None, "sp")), x)
    f = C.run_sharded(lambda pos, a: a * 0 + pos["sp"], mesh,
                      (C.P("sp"),), C.P("sp"))
    got = f(torch.zeros(8, 2))
    assert torch.equal(got[:, 0], torch.tensor([0., 0, 1, 1, 2, 2, 3, 3]))


def test_collectives_hand_each_position_its_own_tensor():
    """On a repeated device a ppermute or all-to-all still copies: an
    in-place update at one position reaches no other."""
    mesh = _tmesh("sp", 4)
    xs = [torch.full((4, 2), float(i)) for i in range(4)]
    before = telemetry.counter("parallel.transfers").value
    rolled = C.ppermute(xs, mesh, "sp", [(j, (j + 1) % 4) for j in range(4)])
    assert [float(r[0, 0]) for r in rolled] == [3.0, 0.0, 1.0, 2.0]
    assert telemetry.counter("parallel.transfers").value - before == 4
    rolled[1].add_(100)
    assert float(xs[0][0, 0]) == 0.0
    half = C.ppermute(xs, mesh, "sp", [(0, 1)])
    assert float(half[1][0, 0]) == 0.0 and float(half[2].abs().sum()) == 0.0
    swapped = C.all_to_all(xs, mesh, "sp", split_axis=0, concat_axis=1)
    assert swapped[2].shape == (1, 8)
    assert swapped[2][0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    swapped[2].add_(7)
    assert float(xs[2].sum()) == 16.0
    total = C.psum(xs, mesh, "sp")
    assert all(float(t[0, 0]) == 6.0 for t in total)
    assert len({t.data_ptr() for t in total}) == 4
    assert [float(t[0, 0]) for t in C.pmean(xs, mesh, "sp")] == [1.5] * 4


def test_all_to_all_matches_jax_tiled_and_not():
    n = 4
    rng = np.random.RandomState(0)
    x = rng.randn(n, 8, 4, 6).astype(np.float32)   # one (8, 4, 6) per device
    jmesh = _jmesh("ep", n)
    from jax.sharding import PartitionSpec as P

    from mxnet_tpu.parallel.ring import _shard_map

    for split, concat, tiled, per in ((0, 1, True, (8, 4, 6)),
                                      (1, 0, True, (8, 4, 6)),
                                      (0, 0, False, (4, 2, 6))):
        xx = x if tiled else x[:, :4, :2]
        body = lambda a: jax.lax.all_to_all(a[0], "ep", split, concat,
                                            tiled=tiled)[None]
        want = np.asarray(_shard_map(body, jmesh, (P("ep"),), P("ep"))(
            jnp.asarray(xx)))
        got = C.all_to_all([torch.tensor(xx[i]) for i in range(n)],
                           _tmesh("ep", n), "ep", split, concat, tiled=tiled)
        for i in range(n):
            np.testing.assert_array_equal(got[i].numpy(), want[i])
        assert tuple(got[0].shape) == (want.shape[1:]), per


# ------------------------------------------------------- ring, ulysses
def _qkvg(seed, b, h, s, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _jax_attn(fn, mesh, q, k, v, g, causal):
    def loss(q, k, v):
        out = fn(q, k, v, mesh, axis="sp", causal=causal)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return np.asarray(out), [np.asarray(a) for a in grads]


def _port_attn(fn, mesh, q, k, v, g, causal):
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fn(tq, tk, tv, mesh, axis="sp", causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    return out.detach().numpy(), [a.numpy() for a in grads]


@pytest.mark.parametrize("scheme,n,causal", [
    ("ring", 4, False), ("ring", 8, True),
    ("ulysses", 4, True), ("ulysses", 8, False)])
def test_sequence_parallel_attention_matches_jax(scheme, n, causal):
    q, k, v, g = _qkvg(n + causal, 2, 8, 64, 16)
    jfn = getattr(JP, scheme + "_attention")
    tfn = getattr(mx.parallel, scheme + "_attention")
    want, wgrads = _jax_attn(jfn, _jmesh("sp", n), q, k, v, g, causal)
    got, grads = _port_attn(tfn, _tmesh("sp", n), q, k, v, g, causal)
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    for a, b, name in zip(grads, wgrads, "qkv"):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg="d" + name)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_runs_the_flash_kernels_block_by_block(monkeypatch, causal):
    """Causal over n positions: n(n+1)/2 forward calls (the diagonal ones
    causal) and as many backward calls; not causal: n². Ulysses: one of
    each per position."""
    from mxnet_tpu_torch.ops import attention as A

    calls = {"fwd": [], "bwd": []}
    fwd, bwd = A.flash_attention_forward, A.flash_attention_backward_f32
    monkeypatch.setattr(A, "flash_attention_forward", lambda *a: (
        calls["fwd"].append(a[3]), fwd(*a))[1])
    monkeypatch.setattr(A, "flash_attention_backward_f32", lambda *a: (
        calls["bwd"].append(a[6]), bwd(*a))[1])
    n = 4
    q, k, v, g = _qkvg(0, 1, 4, 32, 8)
    _port_attn(mx.parallel.ring_attention, _tmesh("sp", n), q, k, v, g, causal)
    want = n * (n + 1) // 2 if causal else n * n
    assert len(calls["fwd"]) == len(calls["bwd"]) == want
    assert sum(calls["fwd"]) == sum(calls["bwd"]) == (n if causal else 0)


def test_ring_backward_sums_float32_parts_for_bf16_inputs():
    """bf16 shards: each block's gradient is summed in float32 and rounded
    once, so the ring's gradient is the whole sequence's to bf16
    rounding."""
    from mxnet_tpu_torch.ops.attention import attention_reference

    q, k, v, g = _qkvg(3, 1, 4, 64, 16)
    mesh = _tmesh("sp", 4)
    tq, tk, tv = (_t(a).bfloat16().requires_grad_(True) for a in (q, k, v))
    out = mx.parallel.ring_attention(tq, tk, tv, mesh, causal=True)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g).bfloat16())
    rq, rk, rv = (_t(a, True) for a in (q, k, v))
    ref = attention_reference(rq, rk, rv, True)
    rgrads = torch.autograd.grad(ref, (rq, rk, rv), _t(g))
    assert out.dtype == torch.bfloat16
    for a, b in zip(grads, rgrads):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=0.06,
                                   rtol=0.02)


def test_ulysses_raises_the_jax_errors():
    mesh = _tmesh("sp", 4)
    x = torch.zeros(1, 6, 8, 8)
    with pytest.raises(ValueError, match="heads 6"):
        mx.parallel.ulysses_attention(x, x, x, mesh)
    y = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match="seq len 6"):
        mx.parallel.ulysses_attention(y, y, y, mesh)
    with pytest.raises(ValueError, match="seq len 6"):
        mx.parallel.ring_attention(y, y, y, mesh)


# ------------------------------------------------------------ pipeline
def _stage(params, x):
    W, b = params
    return (x @ W + b).tanh()


def _jstage(params, x):
    W, b = params
    return jnp.tanh(x @ W + b)


def test_homogeneous_pipeline_matches_jax_with_gradients():
    S, M, B, D = 4, 6, 3, 8
    rng = np.random.RandomState(S)
    Ws = rng.randn(S, D, D).astype(np.float32) * 0.3
    bs = rng.randn(S, D).astype(np.float32) * 0.1
    xs = rng.randn(M, B, D).astype(np.float32)
    jm = _jmesh("pp", S)

    def jloss(p):
        out = JP.pipeline_apply(_jstage, p, jnp.asarray(xs), jm)
        return jnp.sum(out ** 2), out

    (_, want), wg = jax.value_and_grad(jloss, has_aux=True)(
        (jnp.asarray(Ws), jnp.asarray(bs)))
    tW, tb = _t(Ws, True), _t(bs, True)
    out = mx.parallel.pipeline_apply(_stage, (tW, tb), _t(xs), _tmesh("pp", S))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    gW, gb = torch.autograd.grad((out ** 2).sum(), (tW, tb))
    np.testing.assert_allclose(gW.numpy(), np.asarray(wg[0]), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wg[1]), rtol=2e-3, atol=2e-4)


def test_heterogeneous_pipeline_matches_jax_with_gradients():
    """Different stage bodies, int tokens in and a float carry out; the
    gradients of every stage's own parameters."""
    D = 8
    rng = np.random.RandomState(0)
    emb = rng.rand(11, D).astype(np.float32)
    w1 = rng.randn(D, D).astype(np.float32) * 0.3
    w2 = rng.randn(D, D).astype(np.float32) * 0.3
    b3 = rng.randn(D).astype(np.float32) * 0.1
    xs = rng.randint(0, 11, (5, 2, 3)).astype(np.int32)
    jfns = [lambda p, tok: p[tok.astype(jnp.int32)],
            lambda p, x: jax.nn.relu(x @ p),
            lambda p, x: jnp.tanh(x @ p),
            lambda p, x: x + p]
    tfns = [lambda p, tok: p[tok.long()],
            lambda p, x: torch.relu(x @ p),
            lambda p, x: torch.tanh(x @ p),
            lambda p, x: x + p]
    jm = _jmesh("pp", 4)

    def jloss(ps):
        out = JP.pipeline_apply(jfns, list(ps), xs, jm, carry_shape=(2, 3, D),
                                carry_dtype=np.float32)
        return jnp.sum(out ** 2), out

    (_, want), wg = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(a) for a in (emb, w1, w2, b3)))
    tp = [_t(a, True) for a in (emb, w1, w2, b3)]
    out = mx.parallel.pipeline_apply(tfns, tp, _t(xs), _tmesh("pp", 4),
                                     carry_shape=(2, 3, D),
                                     carry_dtype=np.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((out ** 2).sum(), tp)
    for a, b in zip(grads, wg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_pipeline_runs_each_stage_once_per_microbatch():
    """The port skips the fill and drain ticks the JAX package masks: M
    calls of every stage."""
    S, M, D = 3, 5, 4
    seen = []

    def stage(p, x):
        seen.append(float(p[0]))
        return x + p

    params = torch.arange(S, dtype=torch.float32)[:, None].repeat(1, D)
    out = mx.parallel.pipeline_apply(stage, params, torch.zeros(M, 2, D),
                                     _tmesh("pp", S))
    assert sorted(seen) == sorted([0.0, 1.0, 2.0] * M)
    assert torch.equal(out, torch.full((M, 2, D), 3.0))
    with pytest.raises(ValueError, match="stage fns"):
        mx.parallel.pipeline_apply([stage] * 2, [params[0]] * 2,
                                   torch.zeros(M, 2, D), _tmesh("pp", S))


# ----------------------------------------------------------------- moe
def _moe_inputs(seed, N, D, H, E):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, D).astype(np.float32),
            rng.randn(D, E).astype(np.float32),
            rng.randn(E, D, H).astype(np.float32) * 0.2,
            rng.randn(E, H, D).astype(np.float32) * 0.2)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["ample", "tight"])
def test_moe_matches_jax_with_gradients(cf):
    n, N, D, H, E = 4, 32, 8, 16, 8
    x, gw, w1, w2 = _moe_inputs(0, N, D, H, E)
    jm = _jmesh("ep", n)

    def jloss(x, gw, w1, w2):
        y = JP.moe_ffn(x, gw, w1, w2, jm, axis="ep", capacity_factor=cf)
        return jnp.sum(y ** 2), y

    (_, want), wg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(x, gw, w1, w2)
    tp = [_t(a, True) for a in (x, gw, w1, w2)]
    y = mx.parallel.moe_ffn(*tp, _tmesh("ep", n), axis="ep", capacity_factor=cf)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    # ample: C = int(B * cf / E) = B slots, none dropped; tight: C = 1
    dropped = np.abs(np.asarray(want)).sum(1) == 0
    assert (cf < 1) == bool(dropped.any())
    # a token over capacity contributes exactly 0
    assert (y.detach().numpy()[dropped] == 0).all()
    grads = torch.autograd.grad((y ** 2).sum(), tp)
    for a, b, name in zip(grads, wg, ("x", "gate", "w1", "w2")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def test_moe_custom_expert_body_matches_jax():
    n, N, D, H, E = 4, 32, 8, 16, 4
    rng = np.random.RandomState(2)
    x = rng.randn(N, D).astype(np.float32)
    gw = rng.randn(D, E).astype(np.float32)
    wa, wb = (rng.randn(E, D, H).astype(np.float32) * 0.2 for _ in range(2))
    wo = rng.randn(E, H, D).astype(np.float32) * 0.2
    jm = _jmesh("ep", n)

    def jglu(p, t):
        a, b, o = p
        return (jax.nn.silu(t @ a) * (t @ b)) @ o

    def tglu(p, t):
        a, b, o = p
        return (torch.nn.functional.silu(t @ a) * (t @ b)) @ o

    def jloss(wa):
        y = JP.moe_ffn(x, gw, None, None, jm, axis="ep", expert_fn=jglu,
                       expert_params=(wa, wb, wo), capacity_factor=4.0)
        return jnp.sum(y ** 2), y

    (_, want), wg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(wa))
    ta = _t(wa, True)
    y = mx.parallel.moe_ffn(_t(x), _t(gw), None, None, _tmesh("ep", n),
                            axis="ep", expert_fn=tglu,
                            expert_params=(ta, _t(wb), _t(wo)),
                            capacity_factor=4.0)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    (g,) = torch.autograd.grad((y ** 2).sum(), (ta,))
    np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError, match="expert_params"):
        mx.parallel.moe_ffn(_t(x), _t(gw), None, None, _tmesh("ep", n),
                            expert_fn=tglu)


def test_moe_routing_ties_take_the_first_expert():
    """A router that scores two experts equally sends the token to the
    lower index, as jnp.argmax does."""
    x = torch.ones(4, 2)
    gw = torch.zeros(2, 4)
    dispatch, gate = TM._dispatch(x, gw, 4, 4)
    assert dispatch.sum(dim=(0, 2)).tolist() == [4.0, 0.0, 0.0, 0.0]
    assert torch.allclose(gate, torch.full((4,), 0.25))


def test_all_gather_and_reduce_scatter_are_the_lax_collectives():
    """``all_gather`` and ``reduce_scatter`` (tiled) over one axis of a
    2x2 mesh against ``lax.all_gather``/``lax.psum_scatter`` under
    ``shard_map``; copies counted, and inside ``tally_transfers`` (what a
    CUDA-graph capture runs under) tallied instead of counted."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JSpec

    with mx.cpu():
        mesh = build_mesh({"a": 2, "b": 2})
    rng = np.random.RandomState(1)
    xs = [rng.randn(4, 3).astype(np.float32) for _ in range(4)]
    before = telemetry.counter("parallel.transfers").value
    ag = C.all_gather([torch.tensor(v) for v in xs], mesh, "b", dim=0)
    rs = C.reduce_scatter([torch.tensor(v) for v in xs], mesh, "b", dim=0)
    assert telemetry.counter("parallel.transfers").value - before == 16
    with C.tally_transfers() as tally:
        C.psum([torch.tensor(v) for v in xs], mesh, "a")
    # each group sums at its first position (no copy there: one device)
    # and copies the sum to both
    assert tally == [4, 4 * 4 * 3 * 4]
    assert telemetry.counter("parallel.transfers").value - before == 16

    jm = JP.build_mesh({"a": 2, "b": 2}, jax.devices("cpu")[:4])
    glob = np.stack(xs).reshape(2, 2, 4, 3)

    def body(x):
        x = x[0, 0]
        return (jax.lax.all_gather(x, "b", tiled=True)[None, None],
                jax.lax.psum_scatter(x, "b", tiled=True)[None, None])

    f = shard_map(body, mesh=jm, in_specs=JSpec("a", "b"),
                  out_specs=(JSpec("a", "b"), JSpec("a", "b")))
    jag, jrs = f(jnp.asarray(glob))
    for p in range(4):
        i, j = divmod(p, 2)
        np.testing.assert_allclose(ag[p].numpy(), np.asarray(jag)[i, j], rtol=0, atol=0)
        np.testing.assert_allclose(rs[p].numpy(), np.asarray(jrs)[i, j],
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        C.reduce_scatter([torch.zeros(3)] * 4, mesh, "b")
