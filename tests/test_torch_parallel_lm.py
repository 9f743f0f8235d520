"""The dense, sp, pp and ep LM trainers and ``mx.mod.ParallelLMModule``
of the port (``mxnet_tpu_torch/parallel/lm.py``,
``module/parallel_module.py``) against the JAX package's on the CPU, at
the JAX tests' sizes.

For each mode both packages' ``ParallelLMModule`` fit the same batches
from the same parameters; then each module's trainer runs ``forward``
and five more ``step``\\ s from where its fit ended. Tolerances, from the
JAX package's own tests: losses rtol 2e-4, parameters rtol 2e-3 / atol
2e-5, logits rtol 2e-4 / atol 2e-4, perplexity rtol 2e-4."""
import os

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu.parallel import lm as JL
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import lm as TL

VOCAB, LAYERS, DIM, HEADS, FFN, SEQ = 101, 4, 32, 4, 64, 32
B = 8
EXPERTS = 4
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5
LOGIT_TOL = 2e-4
MODES = ("dense", "sp", "pp", "ep")


def _cfg():
    return dict(vocab_size=VOCAB, num_layers=LAYERS, model_dim=DIM,
                num_heads=HEADS, ffn_dim=FFN, seq_len=SEQ)


def _data(seed=0, batch=B):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, VOCAB, (batch, SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.int32)


class _Iter:
    """Four seeded batches of (B, SEQ) tokens and next-token labels."""

    def __init__(self, mx, n_batches=4, seed=0):
        self.mx = mx
        self.provide_data = [mx.io.DataDesc("data", (B, SEQ))]
        self.provide_label = [mx.io.DataDesc("softmax_label", (B, SEQ))]
        self.batch_size = B
        self.n, self.seed, self.i = n_batches, seed, 0

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        self.i = 0

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        tok, lab = _data(seed=self.seed * 100 + self.i)
        self.i += 1
        nd = self.mx.nd
        return self.mx.io.DataBatch([nd.array(tok.astype(np.float32))],
                                    [nd.array(lab.astype(np.float32))], pad=0)

    next = __next__


def _module(mx, mode):
    extra = dict(num_devices=4) if mode != "dense" else {}
    if mode == "pp":
        extra["microbatches"] = 4
    if mode == "ep":
        extra["num_experts"] = EXPERTS
    return mx.mod.ParallelLMModule(mode=mode, seed=7, **_cfg(), **extra)


def _init(mode):
    cfg = dict(_cfg(), num_experts=EXPERTS if mode == "ep" else 0)
    return JL.init_lm_params(7, **cfg)


def _fit(mx, mode):
    mod = _module(mx, mode)
    losses = []
    mod.fit(_Iter(mx), num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=_init(mode),
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            batch_end_callback=[lambda p: losses.append(mod.loss)])
    args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    score = mod.score(_Iter(mx, seed=1), mx.metric.Perplexity(ignore_label=None))
    return mod, losses, args, score[0][1]


_FITS = {}


def _fits(mode):
    """Both packages' fit of ``mode`` (once per process)."""
    if mode not in _FITS:
        with T.cpu():
            _FITS[mode] = (_fit(J, mode), _fit(T, mode))
    return _FITS[mode]


def _assert_params(got, want, what):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg="%s %s" % (what, k))


def test_init_lm_params_is_the_jax_packages_bitwise():
    for experts in (0, EXPERTS):
        want = JL.init_lm_params(3, num_experts=experts, **_cfg())
        got = TL.init_lm_params(3, num_experts=experts, **_cfg())
        assert list(got) == list(want) == TL.lm_param_names(
            LAYERS, num_experts=experts)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_parallel_module_fit_and_score_match_jax(mode):
    (_, jl, ja, js), (mod, tl, ta, ts) = _fits(mode)
    assert len(tl) == len(jl) == 8 and None not in tl
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params(ta, ja, mode)
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    assert mod.get_outputs()[0].shape == (B * SEQ, VOCAB)


@pytest.mark.parametrize("mode", MODES)
def test_trainer_forward_and_five_steps_match_jax(mode):
    """Each mode's trainer, from where its fit ended: the logits of a batch,
    then five steps (the losses and the parameters after them)."""
    (jmod, _, _, _), (tmod, _, _, _) = _fits(mode)
    jt, tt = jmod._trainer, tmod._trainer
    assert type(tt).__name__ == type(jt).__name__
    # copies laid out as the JAX module lays them out (its compiled step is
    # reused; the JAX step donates what it is given)
    jp = {k: v.copy() for k, v in jmod._params.items()}
    js = {k: tuple(s.copy() for s in v) for k, v in jmod._opt_state.items()}
    tp, ts = tmod._params, tmod._opt_state
    batch = next(iter(_Iter(J, seed=9)))
    jtok, jlab = jmod._tokens_labels(batch)
    with T.cpu():
        ttok, tlab = tmod._tokens_labels(next(iter(_Iter(T, seed=9))))
        np.testing.assert_allclose(tt.forward(tp, ttok).numpy(),
                                   np.asarray(jt.forward(jp, jtok)),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jl, tl = [], []
        for _ in range(5):
            jp, js, loss = jt.step(jp, js, jtok, jlab)
            jl.append(float(loss))
            tp, ts, loss = tt.step(tp, ts, ttok, tlab)
            tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params({k: v.numpy() for k, v in tp.items()},
                   {k: np.asarray(v) for k, v in jp.items()}, mode)


def test_sp_and_pp_losses_are_dense_ones():
    """The math does not change with the mode: sp shards the sequence, pp
    pipelines the blocks."""
    dense = _fits("dense")[1][1]
    for mode in ("sp", "pp"):
        np.testing.assert_allclose(_fits(mode)[1][1], dense, rtol=LOSS_RTOL,
                                   err_msg=mode)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_dense_checkpoint_warm_starts_sp(tmp_path, source):
    """A dense run's ``.params`` file, written by either package, loads
    into an sp module: the same parameters, and the first sp step's loss
    is the next dense step's."""
    (jmod, _, _, _), (tmod, _, _, _) = _fits("dense")
    fname = os.path.join(str(tmp_path), "lm.params")
    writer = jmod if source == "jax" else tmod
    writer.save_params(fname)
    want = {k: v.asnumpy() for k, v in writer.get_params()[0].items()}
    with T.cpu():
        sp = _module(T, "sp")
        it = _Iter(T)
        sp.bind(it.provide_data, it.provide_label)
        sp.load_params(fname)
        sp.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1})
        got = {k: v.asnumpy() for k, v in sp.get_params()[0].items()}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        dense = _module(T, "dense")
        dense.bind(it.provide_data, it.provide_label)
        dense.load_params(fname)
        dense.init_optimizer(optimizer="sgd",
                             optimizer_params={"learning_rate": 0.1})
        batch = next(iter(it))
        for m in (sp, dense):
            m.forward_backward(batch)
            m.update()
    np.testing.assert_allclose(sp.loss, dense.loss, rtol=LOSS_RTOL)


def test_module_and_trainer_refusals():
    with pytest.raises(MXNetError, match="unknown mode"):
        T.mod.ParallelLMModule(mode="tp", **_cfg())
    with pytest.raises(MXNetError, match="num_experts"):
        T.mod.ParallelLMModule(mode="ep", **_cfg())
    with T.cpu():
        mesh = T.parallel.build_mesh({"pp": 3})
        with pytest.raises(ValueError, match="pipeline stages"):
            TL.PPLMTrainer(mesh, **_cfg())
        with pytest.raises(ValueError, match="num_experts"):
            TL.MoELMTrainer(T.parallel.build_mesh({"ep": 3}),
                            num_experts=4, **_cfg())
        mod = _module(T, "pp")
        with pytest.raises(MXNetError, match="microbatches"):
            mod.bind([("data", (6, SEQ))], [("softmax_label", (6, SEQ))])
        with pytest.raises(MXNetError, match="seq_len"):
            _module(T, "dense").bind([("data", (B, SEQ + 1))])
