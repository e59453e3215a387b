"""CTC loss / decoders / metrics vs. independent oracles (SURVEY.md §4:
loss vs. slow NumPy forward-backward + optax; decoder vs. brute force)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from asr_study_tpu.ops import (
    beam_search_decode,
    ctc_loss,
    edit_distance,
    greedy_decode,
    ler,
    wer,
)
from asr_study_tpu.ops.metrics import _levenshtein_py, cer


def _rand_case(key, batch=3, t_max=12, vocab=5, l_max=4):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    logits = jax.random.normal(k1, (batch, t_max, vocab)) * 2.0
    lengths = jax.random.randint(k2, (batch,), t_max // 2, t_max + 1)
    label_lengths = jax.random.randint(k3, (batch,), 1, l_max + 1)
    labels = jax.random.randint(k4, (batch, l_max), 0, vocab - 1)
    return logits, lengths, labels, label_lengths


def _brute_force_nll(log_probs, length, labels, blank):
    """Sum probability of all length-`length` paths collapsing to `labels`."""
    v = log_probs.shape[1]
    total = -np.inf
    for path in itertools.product(range(v), repeat=length):
        # collapse repeats then drop blanks
        collapsed = [k for k, _ in itertools.groupby(path) if k != blank]
        if collapsed == list(labels):
            lp = sum(log_probs[t, path[t]] for t in range(length))
            total = np.logaddexp(total, lp)
    return -total


class TestLogAdd3:
    """The fused one-shot 3-way log-sum-exp (r5) vs np.logaddexp and the
    recursions' floor conventions — it sits on every CTC critical path."""

    def test_matches_numpy_logsumexp(self):
        from asr_study_tpu.ops.ctc import _logadd3

        rng = np.random.RandomState(0)
        a, b, c = (rng.randn(64).astype(np.float32) * 20 for _ in range(3))
        got = np.asarray(_logadd3(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(c)))
        want = np.logaddexp(np.logaddexp(a.astype(np.float64),
                                         b.astype(np.float64)),
                            c.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)

    def test_floor_conventions(self):
        from asr_study_tpu.ops.ctc import LOG_EPS, _logadd3

        f = jnp.float32(LOG_EPS)
        # one real operand dominates two floored ones exactly
        got = float(_logadd3(jnp.float32(-3.5), f, f))
        assert got == pytest.approx(-3.5, abs=1e-6)
        # all three at the floor stay at the floor's scale (log 3 above)
        got = float(_logadd3(f, f, f))
        assert got == pytest.approx(LOG_EPS, rel=1e-6)
        # finite everywhere (the -inf-free LOG_EPS contract)
        assert np.isfinite(got)

    def test_grad_no_nan_at_floor(self):
        from asr_study_tpu.ops.ctc import LOG_EPS, _logadd3

        g = jax.grad(lambda a: _logadd3(a, jnp.float32(LOG_EPS),
                                        jnp.float32(LOG_EPS)))(
            jnp.float32(-2.0))
        assert np.isfinite(float(g))
        assert float(g) == pytest.approx(1.0, abs=1e-6)


class TestCTCLoss:
    def test_matches_optax(self):
        logits, lengths, labels, label_lengths = _rand_case(
            jax.random.PRNGKey(0)
        )
        ours = ctc_loss(logits, lengths, labels, label_lengths)
        t_max, l_max = logits.shape[1], labels.shape[1]
        logit_pad = (jnp.arange(t_max)[None] >= lengths[:, None]).astype(
            jnp.float32
        )
        label_pad = (jnp.arange(l_max)[None] >= label_lengths[:, None]).astype(
            jnp.float32
        )
        theirs = optax.ctc_loss(
            logits, logit_pad, labels, label_pad,
            blank_id=logits.shape[-1] - 1,
        )
        np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=1e-4)

    def test_matches_brute_force(self):
        key = jax.random.PRNGKey(1)
        logits = jax.random.normal(key, (1, 6, 3))
        lp = np.array(jax.nn.log_softmax(logits, axis=-1))[0]
        labels = np.array([[0, 1]])
        got = ctc_loss(
            logits, jnp.array([6]), jnp.array(labels), jnp.array([2])
        )[0]
        want = _brute_force_nll(lp, 6, [0, 1], blank=2)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_repeated_labels(self):
        key = jax.random.PRNGKey(2)
        logits = jax.random.normal(key, (1, 8, 3))
        lp = np.array(jax.nn.log_softmax(logits, axis=-1))[0]
        got = ctc_loss(
            logits, jnp.array([8]), jnp.array([[1, 1, 0]]), jnp.array([3])
        )[0]
        want = _brute_force_nll(lp, 8, [1, 1, 0], blank=2)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_infeasible_is_finite(self):
        # 2L+1 > T with repeats: impossible alignment must stay finite.
        logits = jnp.zeros((1, 3, 3))
        loss = ctc_loss(
            logits, jnp.array([3]), jnp.array([[1, 1, 1]]), jnp.array([3])
        )
        assert np.isfinite(float(loss[0]))

    def test_grads_match_optax_and_finite(self):
        logits, lengths, labels, label_lengths = _rand_case(
            jax.random.PRNGKey(3)
        )
        g_ours = jax.grad(
            lambda lg: jnp.sum(ctc_loss(lg, lengths, labels, label_lengths))
        )(logits)
        t_max, l_max = logits.shape[1], labels.shape[1]
        logit_pad = (jnp.arange(t_max)[None] >= lengths[:, None]).astype(
            jnp.float32
        )
        label_pad = (jnp.arange(l_max)[None] >= label_lengths[:, None]).astype(
            jnp.float32
        )
        g_optax = jax.grad(
            lambda lg: jnp.sum(
                optax.ctc_loss(
                    lg, logit_pad, labels, label_pad,
                    blank_id=logits.shape[-1] - 1,
                )
            )
        )(logits)
        assert np.all(np.isfinite(np.array(g_ours)))
        np.testing.assert_allclose(g_ours, g_optax, rtol=1e-3, atol=1e-4)

    def test_jit_and_vmap_clean(self):
        logits, lengths, labels, label_lengths = _rand_case(
            jax.random.PRNGKey(4)
        )
        jitted = jax.jit(ctc_loss)
        np.testing.assert_allclose(
            jitted(logits, lengths, labels, label_lengths),
            ctc_loss(logits, lengths, labels, label_lengths),
            rtol=1e-6,
        )


class TestGreedyDecode:
    def test_collapse_semantics(self):
        # path a a b - b  -> "a b b"
        blank = 2
        ids = [0, 0, 1, 2, 1]
        logits = jax.nn.one_hot(jnp.array([ids]), 3) * 10.0
        dec, lens = greedy_decode(logits, jnp.array([5]), blank_id=blank)
        assert int(lens[0]) == 3
        assert dec[0, :3].tolist() == [0, 1, 1]
        assert dec[0, 3:].tolist() == [-1, -1]

    def test_respects_lengths(self):
        blank = 2
        ids = [0, 2, 1, 0, 0]
        logits = jax.nn.one_hot(jnp.array([ids]), 3) * 10.0
        dec, lens = greedy_decode(logits, jnp.array([3]), blank_id=blank)
        assert int(lens[0]) == 2
        assert dec[0, :2].tolist() == [0, 1]

    def test_all_blank(self):
        logits = jax.nn.one_hot(jnp.array([[2, 2, 2]]), 3) * 10.0
        dec, lens = greedy_decode(logits, jnp.array([3]))
        assert int(lens[0]) == 0
        assert dec[0].tolist() == [-1, -1, -1]


class TestBlankCollapse:
    def _peaked_logits(self, key, batch=2, t=20, vocab=4, blank_frac=0.6):
        """Logits where ~blank_frac of frames are blank-dominated."""
        k1, k2 = jax.random.split(key)
        blank = vocab - 1
        is_blank = jax.random.bernoulli(k1, blank_frac, (batch, t))
        ids = jax.random.randint(k2, (batch, t), 0, vocab - 1)
        ids = jnp.where(is_blank, blank, ids)
        return jax.nn.one_hot(ids, vocab) * 12.0  # ~softmax prob 0.9999

    def test_decode_invariant(self):
        from asr_study_tpu.ops.ctc import blank_collapse

        logits = self._peaked_logits(jax.random.PRNGKey(0))
        lens = jnp.array([20, 15])
        packed, new_lens, dropped = blank_collapse(logits, lens, keep_ratio=0.7)
        assert packed.shape[1] == 14
        assert int(dropped.sum()) == 0
        # greedy transcripts identical on collapsed emissions
        d1, l1 = greedy_decode(logits, lens)
        d2, l2 = greedy_decode(packed, new_lens)
        for b in range(2):
            assert (
                d1[b, : int(l1[b])].tolist() == d2[b, : int(l2[b])].tolist()
            )
        # beam transcripts identical too
        b1, bl1, _ = beam_search_decode(logits, lens, beam_width=4)
        b2, bl2, _ = beam_search_decode(packed, new_lens, beam_width=4)
        for b in range(2):
            assert (
                b1[b, 0, : int(bl1[b, 0])].tolist()
                == b2[b, 0, : int(bl2[b, 0])].tolist()
            )

    def test_overflow_clamps(self):
        from asr_study_tpu.ops.ctc import blank_collapse

        # nothing blank-dominated: all frames kept, clamped to T2
        logits = jnp.zeros((1, 10, 3))  # uniform -> blank prob 1/3 < thr
        packed, new_lens, dropped = blank_collapse(
            logits, jnp.array([10]), keep_ratio=0.5
        )
        assert packed.shape[1] == 5
        assert int(new_lens[0]) == 5
        # the 5 overflow frames are reported, not silently lost
        assert int(dropped[0]) == 5


def _py_prefix_beam(log_probs, length, beam_width, blank):
    """Dict-based reference prefix beam search (Hannun-style)."""
    beams = {(): (0.0, -np.inf)}  # prefix -> (log p_blank, log p_nonblank)
    for t in range(length):
        lp = log_probs[t]
        new = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (-np.inf, -np.inf))
            new[prefix] = (np.logaddexp(opb, pb), np.logaddexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            ptot = np.logaddexp(pb, pnb)
            add(prefix, ptot + lp[blank], -np.inf)          # stay via blank
            if prefix:
                add(prefix, -np.inf, pnb + lp[prefix[-1]])  # repeat last
            for c in range(len(lp)):
                if c == blank:
                    continue
                if prefix and c == prefix[-1]:
                    add(prefix + (c,), -np.inf, pb + lp[c])
                else:
                    add(prefix + (c,), -np.inf, ptot + lp[c])
        beams = dict(
            sorted(
                new.items(),
                key=lambda kv: -np.logaddexp(*kv[1]),
            )[:beam_width]
        )
    ranked = sorted(beams.items(), key=lambda kv: -np.logaddexp(*kv[1]))
    return [
        (list(p), float(np.logaddexp(*v))) for p, v in ranked
    ]


class TestBeamSearch:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_python_reference(self, seed):
        key = jax.random.PRNGKey(seed)
        t_max, vocab, width = 7, 4, 8
        logits = jax.random.normal(key, (1, t_max, vocab)) * 1.5
        lp = np.array(jax.nn.log_softmax(logits, axis=-1))[0]
        want = _py_prefix_beam(lp, t_max, width, blank=vocab - 1)
        dec, lens, scores = beam_search_decode(
            logits, jnp.array([t_max]), beam_width=width, top_paths=3
        )
        for p in range(3):
            got = dec[0, p, : int(lens[0, p])].tolist()
            assert got == want[p][0]
            np.testing.assert_allclose(
                float(scores[0, p]), want[p][1], rtol=1e-4, atol=1e-4
            )

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_onehot_select_matches_gather(self, seed, monkeypatch):
        """The one-hot winner reshuffle (ASR_BEAM_SELECT=onehot,
        default) must reproduce the indexed-gather form bit-for-bit:
        float columns, uint32 hash lanes, and the int32 LM context all
        ride exact selections."""
        from asr_study_tpu.text.lm import fit_ngram_lm

        key = jax.random.PRNGKey(100 + seed)
        logits = jax.random.normal(key, (3, 16, 6)) * 2.0
        lens = jnp.array([16, 11, 13])
        lm = fit_ngram_lm(
            [[0, 1, 2, 3], [1, 2, 0], [3, 2, 1, 0, 4]],
            order=3, n_char=5, space_id=4,
        )
        outs = {}
        for mode in ("onehot", "gather"):
            monkeypatch.setenv("ASR_BEAM_SELECT", mode)
            outs[mode] = beam_search_decode(
                logits, lens, beam_width=8, top_paths=4,
                lm=lm, lm_alpha=0.7, lm_beta=0.1,
            )
        for a, b in zip(outs["onehot"], outs["gather"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @staticmethod
    def _decode_masked(mode, monkeypatch):
        monkeypatch.setenv("ASR_BEAM_SELECT", mode)
        key = jax.random.PRNGKey(7)
        logits = jax.random.normal(key, (2, 12, 6)) * 2.0
        logits = logits.at[:, :, 2].set(-jnp.inf)   # class 2 forbidden
        lens = jnp.array([12, 9])
        dec, dlens, scores = beam_search_decode(
            logits, lens, beam_width=4, top_paths=2
        )
        return np.asarray(dec), np.asarray(dlens), np.asarray(scores)

    def test_inf_masked_logits_decode_finite_and_agree(self, monkeypatch):
        """-inf class masking (a standard caller pattern) must not NaN
        the decode: the one-hot contractions floor their score columns
        at LOG_EPS first (0.0 * -inf = NaN would poison every row), and
        both select paths must produce the same prefixes."""
        outs = {}
        for mode in ("onehot", "gather"):
            dec, dlens, scores = self._decode_masked(mode, monkeypatch)
            assert np.isfinite(scores).all(), mode
            assert not (dec == 2).any(), mode
            outs[mode] = (dec, dlens)
        np.testing.assert_array_equal(outs["onehot"][0], outs["gather"][0])
        np.testing.assert_array_equal(outs["onehot"][1], outs["gather"][1])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_pruned_matches_exact_when_unpruned(self, seed):
        key = jax.random.PRNGKey(seed)
        logits = jax.random.normal(key, (2, 8, 5)) * 2.0
        lens = jnp.array([8, 6])
        exact = beam_search_decode(logits, lens, beam_width=6, top_paths=2)
        full_prune = beam_search_decode(
            logits, lens, beam_width=6, top_paths=2, prune=4  # == |V|-1
        )
        for a, b in zip(exact, full_prune):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))

    def test_pruned_still_decodes_peaked_logits(self):
        # strongly peaked posteriors: prune=2 must recover the exact result
        ids = jnp.array([[0, 0, 2, 1, 2, 1, 1, 2]])
        logits = jax.nn.one_hot(ids, 3) * 8.0
        lens = jnp.array([8])
        exact = beam_search_decode(logits, lens, beam_width=4)
        pruned = beam_search_decode(logits, lens, beam_width=4, prune=1)
        np.testing.assert_array_equal(
            np.asarray(exact[0]), np.asarray(pruned[0])
        )

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_hash_collision_does_not_merge(self, seed, monkeypatch):
        """Adversarial lane-1 collisions: degrade the first hash lane to a
        constant multiplier of 0 (lane-1 hash == last char + 1, so EVERY
        pair of prefixes sharing a final char collides). The second lane
        must still keep distinct prefixes apart — decode must match the
        dict-based reference exactly. Guards the 64-bit (two-lane) merge
        key against regressing to single-lane behavior."""
        from asr_study_tpu.ops import beam as beam_mod

        monkeypatch.setattr(beam_mod, "_HASH_MULT", jnp.uint32(0))
        key = jax.random.PRNGKey(seed)
        t_max, vocab, width = 7, 4, 8
        logits = jax.random.normal(key, (1, t_max, vocab)) * 1.5
        lp = np.array(jax.nn.log_softmax(logits, axis=-1))[0]
        want = _py_prefix_beam(lp, t_max, width, blank=vocab - 1)
        dec, lens, scores = beam_mod.beam_search_decode(
            logits, jnp.array([t_max]), beam_width=width, top_paths=3
        )
        for p in range(3):
            got = dec[0, p, : int(lens[0, p])].tolist()
            assert got == want[p][0]
            np.testing.assert_allclose(
                float(scores[0, p]), want[p][1], rtol=1e-4, atol=1e-4
            )

    def test_beats_or_matches_greedy(self):
        key = jax.random.PRNGKey(7)
        logits = jax.random.normal(key, (2, 10, 5))
        lens_in = jnp.array([10, 6])
        dec_b, len_b, score_b = beam_search_decode(
            logits, lens_in, beam_width=8
        )
        # top-beam score must be >= the score of any single path family;
        # sanity: decoding runs under jit and respects lengths
        jitted = jax.jit(
            lambda lg, ln: beam_search_decode(lg, ln, beam_width=8)
        )
        dec_j, len_j, score_j = jitted(logits, lens_in)
        assert dec_j.shape == dec_b.shape
        np.testing.assert_allclose(score_j, score_b, rtol=1e-5)


class TestMetrics:
    @pytest.mark.parametrize("seed", list(range(5)))
    def test_edit_distance_random(self, seed):
        rng = np.random.RandomState(seed)
        h_len, r_len = rng.randint(0, 10), rng.randint(1, 10)
        hyp = rng.randint(0, 4, size=10)
        ref = rng.randint(0, 4, size=10)
        want = _levenshtein_py(list(hyp[:h_len]), list(ref[:r_len]))
        got = edit_distance(
            jnp.array([hyp]), jnp.array([h_len]),
            jnp.array([ref]), jnp.array([r_len]),
        )
        assert int(got[0]) == want

    def test_ler_normalization(self):
        hyp = jnp.array([[0, 1, 2]])
        ref = jnp.array([[0, 1, 1, 2]])
        out = ler(hyp, jnp.array([3]), ref, jnp.array([4]))
        np.testing.assert_allclose(out, [0.25])

    def test_wer_cer(self):
        assert wer(["ola mundo"], ["ola mundo"]) == 0.0
        assert wer(["ola mundo"], ["ola meu mundo"]) == pytest.approx(1 / 3)
        assert cer(["abc"], ["abd"]) == pytest.approx(1 / 3)
