"""The reference against the native oracle, and the faults and the control
it has to catch."""

import numpy as np
import pytest

from cellbench import dna
from cellbench.reference import dp, verify, walk

SM = np.array([[5, -4, -4, -4], [-4, 5, -4, -4], [-4, -4, 5, -4],
               [-4, -4, -4, 5]], dtype=np.int32)


def _pairs(seed, count, related, max_len=70):
    """Random DNA pairs, the longer one the text; related pairs are a
    sequence against a mutated piece of it; letters from two of the four
    now and then, so that ties are common."""
    rng = np.random.default_rng(seed)
    texts, patterns = [], []
    for b in range(count):
        letters = 2 if b % 3 == 0 else 4
        n = int(rng.integers(1, max_len))
        t = rng.integers(0, letters, n).astype(np.int8)
        if related:
            p = dna.mutate(t[:max(1, int(rng.integers(1, n + 1)))], rng,
                           0.08, 0.08, 0.08)
            if len(p) == 0:
                p = t[:1].copy()
        else:
            p = rng.integers(0, letters, int(rng.integers(1, max_len))
                             ).astype(np.int8)
        if len(p) > len(t):
            t, p = p, t
        texts.append(t)
        patterns.append(p)
    return texts, patterns


def _oracle(texts, patterns, local):
    from seqalign_torch.native import bindings

    out = []
    for t, p in zip(texts, patterns):
        at, ap, st, sp, score = bindings.oracle_align(1 if local else 0, t,
                                                      p, SM, 4, 5)
        out.append(verify.Alignment(np.asarray(at), np.asarray(ap), int(st),
                                    int(sp), int(score)))
    return out


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("related", [False, True])
def test_oracle_alignments_pass_and_walk_reproduces_them(local, related):
    texts, patterns = _pairs(7 + related, 60, related)
    outs = _oracle(texts, patterns, local)
    reasons, f = verify.check(texts, patterns, outs, SM, 5, local)
    assert reasons == [None] * len(outs)
    walked = walk.walk(texts, patterns, SM, 5, local, f)
    for o, w in zip(outs, walked):
        assert w is not None
        assert np.array_equal(o.text, w.text)
        assert np.array_equal(o.pattern, w.pattern)
        assert (o.start_text, o.start_pattern, o.score) == (
            w.start_text, w.start_pattern, w.score)


@pytest.mark.parametrize("local", [False, True])
def test_scores_match_the_oracle(local):
    from seqalign_torch.native import bindings

    texts, patterns = _pairs(11, 40, True)
    want = [bindings.oracle_fill(1 if local else 0, t, p, SM, 4, 5)[1]
            for t, p in zip(texts, patterns)]
    assert list(dp.scores(texts, patterns, SM, 5, local)) == want


@pytest.mark.parametrize("local", [False, True])
def test_altered_answers_are_caught(local):
    texts, patterns = _pairs(3, 12, True)
    outs = _oracle(texts, patterns, local)
    o = outs[1]
    letter = np.flatnonzero(o.text != 4)[0]
    text = o.text.copy()
    text[letter] = (text[letter] + 1) % 4
    bad = list(outs)
    bad[1] = verify.Alignment(text, o.pattern, o.start_text,
                              o.start_pattern, o.score)
    bad[2] = None
    o4 = outs[4]
    bad[4] = verify.Alignment(o4.text, o4.pattern, o4.start_text + 1,
                              o4.start_pattern, o4.score)
    o5 = outs[5]
    bad[5] = verify.Alignment(o5.text, o5.pattern, o5.start_text,
                              o5.start_pattern, o5.score - 1)
    reasons, _ = verify.check(texts, patterns, bad, SM, 5, local)
    assert reasons[1] == "letters"
    assert reasons[2] == "missing"
    assert reasons[4] == "starts"
    assert reasons[5] == "score"
    assert [r for i, r in enumerate(reasons) if i not in (1, 2, 4, 5)] == \
        [None] * 8


@pytest.mark.parametrize("local", [False, True])
def test_the_flipped_control_fails(local):
    texts, patterns = _pairs(5, 60, True)
    outs = _oracle(texts, patterns, local)
    flipped = walk.control(texts, patterns, outs, SM, 5, local, "flipped")
    reasons, _ = verify.check(texts, patterns, flipped, SM, 5, local)
    assert sum(r is not None for r in reasons) >= 5


def _saturating(t, p, sm, gap, local):
    """H[m][n] (global) or the best H (local) of a plain loop whose every
    sum saturates at 16 bits."""
    def sat(x):
        return max(dp.INT16_MIN, min(dp.INT16_MAX, x))

    prev = [0 if local else sat(-gap * j) for j in range(len(t) + 1)]
    best = 0
    for i in range(1, len(p) + 1):
        row = [0 if local else sat(-gap * i)]
        for j in range(1, len(t) + 1):
            h = max(sat(prev[j - 1] + int(sm[p[i - 1], t[j - 1]])),
                    sat(prev[j] - gap), sat(row[j - 1] - gap))
            row.append(max(h, 0) if local else h)
            best = max(best, row[-1])
        prev = row
    return best if local else prev[-1]


@pytest.mark.parametrize("local", [False, True])
def test_int16_cells_saturate_as_a_plain_loop(local):
    """Scores scaled so that short pairs reach both ends of the int16
    range: the int16 fill equals a plain saturating loop, and differs
    from the exact fill."""
    sm = SM * 400
    texts, patterns = _pairs(9, 12, True, max_len=90)
    want = [_saturating(t, p, sm, 2000, local)
            for t, p in zip(texts, patterns)]
    assert list(dp.scores(texts, patterns, sm, 2000, local,
                          int16=True)) == want
    exact = dp.scores(texts, patterns, sm, 2000, local)
    assert (np.asarray(want) != exact).any()


@pytest.mark.parametrize("local", [False, True])
def test_the_int16_control_fails_past_its_range(local):
    """A 7,000-letter pair against a lightly mutated copy scores above
    32,767: the int16 control's answer is judged wrong, while the oracle's
    passes."""
    rng = np.random.default_rng(21)
    t = rng.integers(0, 4, 7000).astype(np.int8)
    p = dna.mutate(t, rng, 0.002, 0.002, 0.01)
    texts, patterns = [t], [p]
    outs = _oracle(texts, patterns, local)
    assert outs[0].score > dp.INT16_MAX
    answers = walk.control(texts, patterns, outs, SM, 5, local, "int16")
    assert answers[0].score == dp.scores(texts, patterns, SM, 5, local,
                                         int16=True)[0] <= dp.INT16_MAX
    reasons, _ = verify.check(texts, patterns, answers, SM, 5, local)
    assert reasons[0] == "score"
    assert verify.check(texts, patterns, outs, SM, 5, local)[0] == [None]


def test_band_placement_follows_the_path():
    texts, patterns = _pairs(13, 6, True)
    outs = _oracle(texts, patterns, False)
    lo, width = verify.place_band(texts, patterns, outs, False, 4)
    assert lo.shape == (6, max(len(p) for p in patterns) + 1)
    assert width % 8 == 0 and 8 <= width <= verify.WIDTH_CAP
    assert (lo[:, 0] <= -1).all()


@pytest.mark.parametrize("width", [4, 8, 32])
@pytest.mark.parametrize("local", [False, True])
def test_running_max_chunks(monkeypatch, width, local):
    """Every chunk width of the running maximum gives the same fill."""
    texts, patterns = _pairs(17, 20, True)
    want = dp.scores(texts, patterns, SM, 5, local)
    monkeypatch.setattr(dp, "SCAN_WIDTH", width)
    assert list(dp.scores(texts, patterns, SM, 5, local)) == list(want)
