"""NDArray and Symbol operators and helpers of the port against the JAX
package, on the CPU: the Python operators with an NDArray or a number on
either side (0/1 comparisons in the input's dtype, ``== None``), the
in-place forms, the module functions (``mx.nd.power`` ... ``lesser_equal``,
``arange``, ``concatenate``, ``moveaxis``, ``onehot_encode``), identity
hashing (NDArrays as dict keys and set members), and ``mx.sym``'s ``**``,
``pow``/``maximum``/``minimum``/``hypot``/``arange`` (the same JSON, byte
for byte, and the same values once bound). Float32: 1e-6 relative, the
comparisons and integer results exactly.
"""
import operator

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T

R = np.random.RandomState(0)
A = R.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
B = R.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
B[0, :2] = A[0, :2]                      # ties for the comparisons
COL = R.uniform(0.5, 2.0, (3, 1)).astype(np.float32)
INTS = R.randint(-3, 4, (3, 4)).astype(np.float32)


def _nd(mx, a):
    return mx.nd.array(a, ctx=mx.cpu())


def _both(fn):
    """fn(package) through the JAX package and the port, as numpy."""
    out = []
    for mx in (J, T):
        r = fn(mx)
        out.append(r.asnumpy() if hasattr(r, "asnumpy") else r)
    return out


def _same(got, want, exact=False):
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "mod": operator.mod, "pow": operator.pow,
    "eq": operator.eq, "ne": operator.ne, "gt": operator.gt,
    "ge": operator.ge, "lt": operator.lt, "le": operator.le,
}
EXACT = {"eq", "ne", "gt", "ge", "lt", "le"}


@pytest.mark.parametrize("rhs", ["array", "broadcast", "scalar", "rscalar"])
@pytest.mark.parametrize("op", sorted(BINARY))
def test_operator_matches_jax(op, rhs):
    f = BINARY[op]

    def run(mx):
        a = _nd(mx, INTS if op == "mod" else A)
        if rhs == "array":
            return f(a, _nd(mx, B))
        if rhs == "broadcast":
            return f(a, _nd(mx, COL))
        if rhs == "scalar":
            return f(a, 1.5)
        return f(1.5, a)

    if rhs == "rscalar" and op in ("mod", "pow"):
        # neither package defines __rmod__ or __rpow__ (as the reference)
        for mx in (J, T):
            with pytest.raises(TypeError):
                run(mx)
        return
    got, want = _both(run)[::-1]
    _same(got, want, exact=op in EXACT)


@pytest.mark.parametrize("op", ["neg", "abs"])
def test_unary_operator_matches_jax(op):
    f = getattr(operator, op)
    got, want = _both(lambda mx: f(_nd(mx, A - 1.25)))[::-1]
    _same(got, want)


@pytest.mark.parametrize("op", ["iadd", "isub", "imul", "itruediv"])
def test_inplace_operator_matches_jax_and_keeps_the_tensor(op):
    f = getattr(operator, op)
    want = _both(lambda mx: f(_nd(mx, A), _nd(mx, B)))[0]
    a = _nd(T, A)
    held = a.data
    r = f(a, _nd(T, B))
    assert r is a and a.data is held
    _same(a.asnumpy(), want)


def test_eq_none_and_hash():
    a, b = _nd(T, A), _nd(T, A)
    assert (a == None) is False and (a != None) is True  # noqa: E711
    assert hash(a) == id(a) and hash(a) != hash(b)
    d = {a: "a", b: "b"}
    assert d[a] == "a" and d[b] == "b"
    assert len({a, b, a}) == 2
    assert a in [a] and a in {a}
    # the JAX package does the same
    ja = _nd(J, A)
    assert (ja == None) is False and hash(ja) == id(ja)  # noqa: E711


FUNCS = ["add", "subtract", "multiply", "divide", "power", "maximum",
         "minimum", "equal", "not_equal", "greater", "greater_equal", "lesser",
         "lesser_equal"]


@pytest.mark.parametrize("side", ["both", "scalar_right", "scalar_left"])
@pytest.mark.parametrize("fn", FUNCS)
def test_module_function_matches_jax(fn, side):
    def run(mx):
        f = getattr(mx.nd, fn)
        if side == "both":
            return f(_nd(mx, A), _nd(mx, B))
        if side == "scalar_right":
            return f(_nd(mx, A), 1.25)
        return f(1.25, _nd(mx, A))

    got, want = _both(run)[::-1]
    exact = fn in ("equal", "not_equal", "greater", "greater_equal",
                   "lesser", "lesser_equal")
    _same(got, want, exact=exact)


def test_helpers_match_jax():
    got, want = _both(lambda mx: mx.nd.arange(1, 7, 1.5, repeat=2, ctx=mx.cpu()))[::-1]
    _same(got, want, exact=True)
    got, want = _both(lambda mx: mx.nd.arange(5, ctx=mx.cpu(), dtype="int32"))[::-1]
    _same(got, want, exact=True)
    got, want = _both(lambda mx: mx.nd.concatenate(
        [_nd(mx, A), _nd(mx, B)], axis=1))[::-1]
    _same(got, want, exact=True)
    x = R.randn(2, 3, 4).astype(np.float32)
    got, want = _both(lambda mx: mx.nd.moveaxis(_nd(mx, x), 0, -1))[::-1]
    _same(got, want, exact=True)
    with pytest.raises(ValueError):
        T.nd.moveaxis(_nd(T, x), 3, 0)

    def onehot(mx):
        out = mx.nd.zeros((4, 5), ctx=mx.cpu())
        return mx.nd.onehot_encode(_nd(mx, np.array([0, 3, 4, 1], np.float32)), out)

    got, want = _both(onehot)[::-1]
    _same(got, want, exact=True)
    got, want = _both(lambda mx: _nd(mx, x).T)[::-1]
    _same(got, want, exact=True)
    got, want = _both(lambda mx: _nd(mx, x).astype("float16"))[::-1]
    _same(got, want, exact=True)


def test_views_do_not_alias_their_input():
    a = _nd(T, A)
    t = a.T
    b = T.nd.broadcast_to(_nd(T, COL), shape=(3, 4))
    t[:] = 0
    b[:] = 7
    _same(a.asnumpy(), A, exact=True)


SYM = {
    "pow": lambda mx, x, y: x ** y,
    "pow_scalar": lambda mx, x, y: x ** 2.0,
    "sym.pow": lambda mx, x, y: mx.sym.pow(x, y),
    "sym.pow_rscalar": lambda mx, x, y: mx.sym.pow(2.0, y),
    "maximum": lambda mx, x, y: mx.sym.maximum(x, y),
    "maximum_scalar": lambda mx, x, y: mx.sym.maximum(0.9, x),
    "minimum": lambda mx, x, y: mx.sym.minimum(x, y),
    "minimum_scalar": lambda mx, x, y: mx.sym.minimum(x, 1.1),
    "hypot": lambda mx, x, y: mx.sym.hypot(x, y),
    "hypot_scalar": lambda mx, x, y: mx.sym.hypot(x, 3.0),
}


@pytest.mark.parametrize("case", sorted(SYM))
def test_symbol_functions_match_jax(case):
    outs, jsons = [], []
    for mx in (J, T):
        with mx.name.NameManager():
            x, y = mx.sym.Variable("x"), mx.sym.Variable("y")
            s = SYM[case](mx, x, y)
        jsons.append(s.tojson())
        shapes = {n: A.shape for n in s.list_arguments()}
        exe = s.simple_bind(ctx=mx.cpu(), grad_req="null", **shapes)
        for n in s.list_arguments():
            exe.arg_dict[n][:] = A if n == "x" else B
        outs.append(exe.forward()[0].asnumpy())
    assert jsons[0] == jsons[1]
    _same(outs[1], outs[0])


def test_symbol_arange_matches_jax():
    outs, jsons = [], []
    for mx in (J, T):
        with mx.name.NameManager():
            s = mx.sym.arange(2, 9, 2, repeat=3)
        jsons.append(s.tojson())
        outs.append(s.simple_bind(ctx=mx.cpu()).forward()[0].asnumpy())
    assert jsons[0] == jsons[1]
    _same(outs[1], outs[0], exact=True)
