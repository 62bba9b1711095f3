"""The port's linear-chain CRF and CTC (paddle_tpu_torch/ops/crf.py,
ctc.py) and the CTC error evaluator against the JAX package's, on the
CPU, on the same numpy inputs from a seed.

Tolerances: values and gradients in f32 within ``ATOL`` (2e-5) of the
reference's largest magnitude (at least 1), rtol 1e-5 — the forward
algorithms sum the same terms in the same order; only libm's last bits
and XLA's fused log-sum-exp differ. Viterbi tags and greedy CTC tokens
must be equal, ties included (planted: integer emissions, equal
log-probabilities). ``F.ctc_loss`` is a cross-check on feasible
alignments only (rtol 1e-4: another algorithm in another order); on a
label of length 0 and on an infeasible alignment the port must give
JAX's finite values where ``F.ctc_loss`` gives inf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.ops import crf as JC
from paddle_tpu.ops import ctc as JCTC
from paddle_tpu.trainer.evaluator import CTCErrorEvaluator as JCTCEval
from paddle_tpu_torch.ops import crf as C
from paddle_tpu_torch.ops import ctc as CTC
from paddle_tpu_torch.trainer import CTCErrorEvaluator

ATOL = 2e-5


def close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL * scale)


def _crf_inputs(seed, B=5, T=7, N=4, ties=False):
    rs = np.random.RandomState(seed)
    if ties:
        # small integers: many equal path scores
        em = rs.randint(-1, 2, (B, T, N)).astype(np.float32)
        start, end = (rs.randint(0, 2, N).astype(np.float32) for _ in "se")
        trans = rs.randint(-1, 1, (N, N)).astype(np.float32)
    else:
        em = rs.randn(B, T, N).astype(np.float32)
        start, end = (rs.randn(N).astype(np.float32) * 0.5 for _ in "se")
        trans = rs.randn(N, N).astype(np.float32) * 0.5
    lens = np.array([T, 1, 0, 4, 6][:B], np.int32)
    tags = rs.randint(0, N, (B, T)).astype(np.int32)
    return em, lens, start, end, trans, tags


@pytest.mark.parametrize("fn", ["crf_log_norm", "crf_loss", "crf_score"])
def test_crf_values_and_grads_match_jax(fn):
    em, lens, start, end, trans, tags = _crf_inputs(0)

    def jf(e, s, en, tr):
        args = (e, tags, lens, s, en, tr) if fn != "crf_log_norm" else (
            e, lens, s, en, tr)
        return jnp.sum(getattr(JC, fn)(*args) * jnp.arange(1.0, 6.0))

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (em, start, end, trans)))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (em, start, end, trans)]
    e, s, en, tr = leaves
    tl = torch.tensor(lens)
    args = ((e, torch.tensor(tags), tl, s, en, tr) if fn != "crf_log_norm"
            else (e, tl, s, en, tr))
    tv = torch.sum(getattr(C, fn)(*args) * torch.arange(1.0, 6.0))
    close(tv, jv)
    for g, w in zip(torch.autograd.grad(tv, leaves), jg):
        close(g, w)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_crf_decode_matches_jax(seed, ties):
    em, lens, start, end, trans, _ = _crf_inputs(seed, ties=ties)
    jt, js = jax.jit(JC.crf_decode)(*(jnp.asarray(a) for a in (
        em, lens, start, end, trans)))
    tt, ts = C.crf_decode(*(torch.tensor(a) for a in (em, lens, start, end,
                                                      trans)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    close(ts, js)
    # the decoded path scores its Viterbi score, and is zero past a length
    assert not tt.numpy()[2].any() and not tt.numpy()[1, 1:].any()
    sc = C.crf_score(torch.tensor(em), tt, torch.tensor(lens),
                     *(torch.tensor(a) for a in (start, end, trans)))
    ok = lens > 0
    close(sc[ok], ts[ok])


def test_crf_decode_ties_go_to_the_lower_tag():
    """All-equal scores: every path ties, and the first maximum is tag 0
    at every step (JAX's argmax), the identity backpointers on padding."""
    B, T, N = 2, 5, 3
    z = np.zeros((B, T, N), np.float32)
    args = (z, np.array([5, 2], np.int32), np.zeros(N, np.float32),
            np.zeros(N, np.float32), np.zeros((N, N), np.float32))
    tt, _ = C.crf_decode(*(torch.tensor(a) for a in args))
    jt, _ = JC.crf_decode(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert not tt.any()


# ------------------------------------------------------------------------- ctc

def _ctc_inputs(seed, B=6, T=9, V=5, L=4):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, T, V).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = rs.randint(1, V, (B, L)).astype(np.int32)
    labels[1, :3] = (2, 2, 3)                  # a repeat needs a blank
    in_lens = np.array([T, 7, 9, 5, 3, 9], np.int32)[:B]
    lab_lens = np.array([4, 3, 0, 2, 4, 1], np.int32)[:B]   # row 4: infeasible
    return lp, in_lens, labels, lab_lens


@pytest.mark.parametrize("blank", [0, 4])
def test_ctc_loss_and_grad_match_jax(blank):
    lp, il, lab, ll = _ctc_inputs(3)
    if blank:
        lab = np.where(lab == blank, 1, lab)
    w = jnp.arange(1.0, 7.0)
    jv, jg = jax.jit(jax.value_and_grad(lambda x: jnp.sum(JCTC.ctc_loss(
        x, il, lab, ll, blank=blank) * w)))(jnp.asarray(lp))
    x = torch.tensor(lp, requires_grad=True)
    per = CTC.ctc_loss(x, torch.tensor(il), torch.tensor(lab),
                       torch.tensor(ll), blank=blank)
    assert torch.isfinite(per).all()
    tv = torch.sum(per * torch.arange(1.0, 7.0))
    close(tv, jv)
    (g,) = torch.autograd.grad(tv, [x])
    assert torch.isfinite(g).all()
    close(g, jg)
    close(per, JCTC.ctc_loss(jnp.asarray(lp), il, lab, ll, blank=blank))


def test_ctc_loss_against_torch_on_feasible_rows():
    """A cross-check by another algorithm: F.ctc_loss on the feasible rows
    (the label-length-0 row included, which both take as the all-blank
    path) equals the port's; on the infeasible row F.ctc_loss is inf and
    the port gives JAX's finite value."""
    lp, il, lab, ll = _ctc_inputs(4)
    x = torch.tensor(lp)
    ours = CTC.ctc_loss(x, torch.tensor(il), torch.tensor(lab),
                        torch.tensor(ll))
    ref = F.ctc_loss(x.transpose(0, 1), torch.tensor(lab, dtype=torch.long),
                     torch.tensor(il, dtype=torch.long),
                     torch.tensor(ll, dtype=torch.long), blank=0,
                     reduction="none", zero_infinity=False)
    feasible = torch.isfinite(ref)
    assert feasible.tolist() == [True, True, True, True, False, True]
    close(ours[feasible], ref[feasible], rtol=1e-4)
    jax_inf = np.asarray(JCTC.ctc_loss(jnp.asarray(lp), il, lab, ll))[4]
    assert np.isfinite(jax_inf)
    close(ours[4], jax_inf)


def _greedy_inputs(seed, B=5, T=8, V=4):
    rs = np.random.RandomState(seed)
    # integer log-probabilities: ties between tokens at many steps
    lp = rs.randint(-2, 1, (B, T, V)).astype(np.float32)
    lp[0] = 0.0                                 # every step a 4-way tie
    lens = np.array([8, 5, 0, 1, 8], np.int32)[:B]
    return lp, lens


@pytest.mark.parametrize("blank", [0, 2])
@pytest.mark.parametrize("seed", [5, 6])
def test_ctc_greedy_decode_matches_jax(seed, blank):
    lp, lens = _greedy_inputs(seed)
    jt, jl = JCTC.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lens),
                                    blank=blank)
    tt, tl = CTC.ctc_greedy_decode(torch.tensor(lp), torch.tensor(lens),
                                   blank=blank)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_ctc_greedy_decode_keeps_every_token_of_a_full_row():
    """A row whose every step is kept fills all T slots: nothing is
    parked over its last token."""
    lp = np.full((1, 5, 4), -5.0, np.float32)
    for t, tok in enumerate((1, 2, 3, 1, 2)):
        lp[0, t, tok] = 0.0
    tt, tl = CTC.ctc_greedy_decode(torch.tensor(lp), torch.tensor([5]))
    assert tt.tolist() == [[1, 2, 3, 1, 2]] and tl.tolist() == [5]


def test_ctc_error_evaluator_matches_jax():
    lp, il, lab, ll = _ctc_inputs(7)
    je, te = JCTCEval(), CTCErrorEvaluator()
    for _ in range(2):
        je.update(log_probs=jnp.asarray(lp), logit_lengths=jnp.asarray(il),
                  labels=jnp.asarray(lab), label_lengths=jnp.asarray(ll))
        te.update(log_probs=torch.tensor(lp), logit_lengths=torch.tensor(il),
                  labels=torch.tensor(lab), label_lengths=torch.tensor(ll))
    want, got = je.result(), te.result()
    assert got.keys() == want.keys() and te.name == je.name == "ctc_error"
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    tt, tl = CTC.ctc_greedy_decode(torch.tensor(lp), torch.tensor(il))
    te2 = CTCErrorEvaluator()
    te2.update(decoded=tt, decoded_lengths=tl, labels=torch.tensor(lab),
               label_lengths=torch.tensor(ll))
    te2.update(decoded=tt, decoded_lengths=tl, labels=torch.tensor(lab),
               label_lengths=torch.tensor(ll))
    assert te2.result() == got
