"""STK-equivalent decoder stack: MMF/network parsing, netgen parity,
network Viterbi vs. the phoneme-loop golden outputs, KWS, lexicon."""

import os

import numpy as np
import pytest

from phnrec_tpu.decoder.stknet import StkNetworkDecoder, kws_candidates
from phnrec_tpu.io.htk import read_htk
from phnrec_tpu.io.labels import read_rec
from phnrec_tpu.io.mmf import parse_mmf
from phnrec_tpu.io.stknet import parse_stk_network
from phnrec_tpu.kws import KWSNetGenerator
from phnrec_tpu.lexicon import Lexicon, _cipher
from phnrec_tpu.netgen import phn_list_to_hmm_defs, phn_list_to_phn_loop
from phnrec_tpu.phntrans import (PhnTransChecker, PhnTranscriber,
                                 Thresholds)

from conftest import golden, package_dir

CZ_PHONEMES = os.path.join(package_dir("cz"), "dicts", "phonemes")


def test_netgen_byte_parity(tmp_path):
    """Generated MMF + loop network must byte-match the reference's own
    generated artifacts shipped in the packages."""
    phn_list_to_hmm_defs(CZ_PHONEMES, str(tmp_path / "models"), 3)
    phn_list_to_phn_loop(CZ_PHONEMES, str(tmp_path / "network"), "oth")
    assert (tmp_path / "models").read_text() == open(
        os.path.join(package_dir("cz"), "tmp", "models")).read()
    assert (tmp_path / "network").read_text() == open(
        os.path.join(package_dir("cz"), "net", "network")).read()


def test_mmf_parse(tmp_path, seeded_phonemes):
    phn_list_to_hmm_defs(seeded_phonemes, str(tmp_path / "models"), 3)
    ms = parse_mmf(str(tmp_path / "models"))
    assert ms.vec_size == 135 and ms.pdf_obs_vec
    assert len(ms.hmms) == 45
    h = ms.hmms["p00"]
    assert h.n_states == 5 and h.obs_coefs == [0, 1, 2]
    assert h.log_transp[1, 1] == pytest.approx(np.log(0.5))


def test_network_parse(tmp_path, seeded_phonemes):
    phn_list_to_phn_loop(seeded_phonemes, str(tmp_path / "network"), "oth")
    net = parse_stk_network(str(tmp_path / "network"))
    assert len(net.nodes) == 93  # 2 nulls + implicit terminal + 45*(M+W)
    models = [n for n in net.nodes if n.is_model]
    assert len(models) == 45
    # W nodes link back to the loop null
    w = models[0].links[0][0]
    assert w.word == models[0].model
    assert w.links[0][0].is_null


def _loop_decoder(d, phonemes):
    phn_list_to_hmm_defs(phonemes, str(d / "models"), 3)
    phn_list_to_phn_loop(phonemes, str(d / "network"), "oth")
    ms = parse_mmf(str(d / "models"))
    net = parse_stk_network(str(d / "network"))
    return StkNetworkDecoder(ms, net, wpenalty=-4.6875, lm_scale=1.0)


@pytest.fixture(scope="module")
def cz_loop_decoder(tmp_path_factory):
    return _loop_decoder(tmp_path_factory.mktemp("czloop"), CZ_PHONEMES)


@pytest.fixture(scope="module")
def seeded_loop_decoder(tmp_path_factory, seeded_phonemes):
    """The phoneme loop over the seeded CZ-width phoneme list: the same
    135 observation columns as the CZ package, other names."""
    return _loop_decoder(tmp_path_factory.mktemp("seededloop"),
                         seeded_phonemes)


def test_network_decode_matches_phndec_golden(cz_loop_decoder):
    """The generic network decoder over the generated phoneme loop must
    reproduce the PhnDec golden labels (same model, two engines)."""
    post, _, _ = read_htk(golden("fix_cz.post"))
    labels = cz_loop_decoder.decode(np.log(np.maximum(post, 1e-37)))
    gold = read_rec(golden("fix_cz.rec"))
    assert [(l.start_frames, l.end_frames, l.name) for l in labels] == \
        [(g.start_frames, g.end_frames, g.name) for g in gold]
    for l, g in zip(labels, gold):
        assert l.score == pytest.approx(g.score, abs=5e-3)


def test_kws_finds_true_keywords(tmp_path):
    """Keywords present in the utterance must surface with LR around 0 or
    better; absent ones must score far below."""
    phn_list_to_hmm_defs(CZ_PHONEMES, str(tmp_path / "models"), 3)
    lex = Lexicon()
    lex.add_word("nebude", "n e b u d e")
    lex.add_word("takto", "t a k t o")
    lex.add_word("missing", "S S S S")
    gen = KWSNetGenerator(PhnTranscriber(lexicon=lex, mode="lexicon"))
    gen.load_phn_list(CZ_PHONEMES)
    gen.generate(["nebude", "takto", "missing"], str(tmp_path / "kwsnet"))

    dec = StkNetworkDecoder(
        parse_mmf(str(tmp_path / "models")),
        parse_stk_network(str(tmp_path / "kwsnet")),
        wpenalty=0.0, lm_scale=1.0, mode="kws", time_pruning=40)
    post, _, _ = read_htk(golden("fix_cz.post"))
    hits = dec.decode(np.log(np.maximum(post, 1e-37)))
    best = {}
    for h in hits:
        if h.name not in best or h.score > best[h.name].score:
            best[h.name] = h
    # golden transcript: n e b u d e around frames 115-152,
    # t a k t o around 250-290
    assert best["nebude"].score > -10
    assert 100 < best["nebude"].start_frames < 130
    assert best["takto"].score > -10
    assert 240 < best["takto"].start_frames < 260
    assert best["missing"].score < -50


def test_lexicon_text_and_binary(tmp_path):
    p = tmp_path / "lex.txt"
    p.write_text("hello\thh ax l ow\nworld\tw er l d\n")
    lex = Lexicon()
    lex.load(str(p), save_bin=True)
    assert [e.trans for e in lex.get_transcs("hello")] == ["hh ax l ow"]
    bl = tmp_path / "lex.bl"
    assert bl.exists()
    # binary round-trips through the LCG/XOR cipher
    lex2 = Lexicon()
    lex2.load(str(p))   # picks up the .bl
    assert [e.trans for e in lex2.get_transcs("world")] == ["w er l d"]
    raw = bl.read_bytes()
    assert b"hello" not in raw  # actually obfuscated
    assert _cipher(_cipher(b"abc")) == b"abc"


def test_phntrans_modes():
    lex = Lexicon()
    lex.add_word("a", "x y")

    class FakeGPT:
        initialized = True

        def generate(self, word):
            from phnrec_tpu.lexicon import TransEntry
            return [TransEntry("g g", 0.5)]

    pt = PhnTranscriber(lexicon=lex, gpt=FakeGPT(), mode="lexgpt")
    assert [e.trans for e in pt.get_transcs("a")] == ["x y"]   # lex wins
    assert [e.trans for e in pt.get_transcs("b")] == ["g g"]   # fallback
    pt2 = PhnTranscriber(lexicon=lex, gpt=FakeGPT(), mode="union")
    assert len(pt2.get_transcs("a")) == 2


def test_phntranscheck():
    c = PhnTransChecker()
    c.phn_list = {"a", "b"}
    assert c.check("a b a") is None
    assert c.check("a z b") == "z"
    assert PhnTransChecker.transc_len("a b c") == 3


def test_thresholds(tmp_path):
    p = tmp_path / "thr"
    p.write_text("yes 1.5\nno -2.0\n")
    t = Thresholds(default_thr=-10.0)
    t.load(str(p))
    assert t.get("yes") == 1.5
    assert t.get("unknown") == -10.0


def test_decode_batch_matches_per_row(seeded_loop_decoder):
    """Batched scan + device traceback must equal per-row host decode."""
    post, _, _ = read_htk(golden("fix_cz.post"))
    lp = np.log(np.maximum(post, 1e-37)).astype(np.float32)
    rng = np.random.default_rng(0)
    T = lp.shape[0]
    rows = [lp,
            lp[: T // 2],
            lp[: 37],
            np.ascontiguousarray(lp[::-1])]
    n_frames = np.array([r.shape[0] for r in rows], np.int32)
    batch = np.zeros((len(rows), T, lp.shape[1]), np.float32)
    for b, r in enumerate(rows):
        batch[b, : r.shape[0]] = r
    got = seeded_loop_decoder.decode_batch(batch, n_frames)
    for b, r in enumerate(rows):
        want = seeded_loop_decoder.decode(r)
        assert [(l.start_frames, l.end_frames, l.name) for l in got[b]] == \
            [(w.start_frames, w.end_frames, w.name) for w in want], f"row {b}"
        np.testing.assert_allclose([l.score for l in got[b]],
                                   [w.score for w in want], atol=1e-3)


def test_beam_pruning_knob(seeded_loop_decoder):
    """A huge beam changes nothing; a tight beam still yields a valid
    label sequence (greedy survivor path) covering the utterance."""
    post, _, _ = read_htk(golden("fix_cz.post"))
    lp = np.log(np.maximum(post, 1e-37)).astype(np.float32)
    dec = seeded_loop_decoder
    base = dec.decode(lp)
    dec.set_beam_pruning(1e9)
    wide = dec.decode(lp)
    assert [(l.start_frames, l.end_frames, l.name) for l in wide] == \
        [(b.start_frames, b.end_frames, b.name) for b in base]
    dec.set_beam_pruning(1.0)   # very tight
    tight = dec.decode(lp)
    dec.set_beam_pruning(None)
    assert tight, "tight beam must still decode something"
    assert tight[0].start_frames == 0 and tight[-1].end_frames == lp.shape[0]
    for a, b in zip(tight, tight[1:]):
        assert a.end_frames == b.start_frames


def test_kws_tracker_streaming_equals_offline(tmp_path):
    """Feeding KWS frame values through KWSTracker in chunks must produce
    the same hits as the whole-utterance kws_candidates."""
    from phnrec_tpu.decoder.stknet import KWSTracker

    rng = np.random.default_rng(5)
    T, K = 200, 3
    filler = np.cumsum(rng.standard_normal(T)).astype(np.float32)
    word_vals = filler[:, None] + rng.standard_normal((T, K)).astype(
        np.float32) * 3.0
    start_times = np.maximum(
        0, np.arange(T)[:, None] - rng.integers(5, 40, (T, K))).astype(
        np.int64)
    # sprinkle inactive frames
    word_vals[rng.random((T, K)) < 0.05] = -1e30
    keywords = [f"kw{j}" for j in range(K)]

    want = kws_candidates(word_vals, filler, start_times, keywords,
                          time_pruning=40)
    tr = KWSTracker(keywords, time_pruning=40)
    got = []
    for s in range(0, T, 17):
        got.extend(tr.feed(word_vals[s : s + 17], filler[s : s + 17],
                           start_times[s : s + 17]))
    got.extend(tr.finish())
    got.sort(key=lambda h: (h.start, h.end, h.word))
    assert [(h.word, h.start, h.end, round(h.score, 4)) for h in got] == \
        [(h.word, h.start, h.end, round(h.score, 4)) for h in want]


def test_parse_htk_slf_lattice():
    """HTK-SLF dialect: VERSION/N/L header, I= node lines with t=/W=,
    standalone J= arc lines with S=/E=/a=/l= (Net_IO.cc:741-751)."""
    from phnrec_tpu.io.stknet import parse_stk_network

    slf = """\
VERSION=1.0 lmscale=1.0
N=4 L=4
I=0 t=0.00 W=!NULL
I=1 t=0.10 W=hello
I=2 t=0.15 W=world
I=3 t=0.30 W=!NULL
J=0 S=0 E=1 a=-120.5 l=-1.5
J=1 S=0 E=2 l=-2.5
J=2 S=1 E=3 l=0.0
J=3 S=2 E=3 l=-0.25
"""
    net = parse_stk_network(slf, is_text=True)
    assert len(net.nodes) == 4
    n0 = net.nodes[0]
    assert n0.word is None and len(n0.links) == 2
    tgt, like = n0.links[0]
    assert tgt.word == "hello" and like == -1.5
    assert net.nodes[1].links[0][0] is net.nodes[3]
    assert net.last is net.nodes[3]


def test_kws_tracker_improve_kwd_estim():
    """improveKwdEstim re-emits an already-dumped candidate whose end
    moved, flagged new_estim (stkinterface.cpp:350-353)."""
    from phnrec_tpu.decoder.stknet import KWSTracker

    filler = np.zeros(30, np.float32)
    wv = np.full((30, 1), -5.0, np.float32)
    wv[5:12, 0] = np.linspace(-1, 2.0, 7)   # growing LR, end drifts
    wv[20, 0] = 3.0   # the SAME hypothesis improves after the stale dump
    st = np.zeros((30, 1), np.int64)
    tr = KWSTracker(["kw"], time_pruning=4, improve_kwd_estim=True)
    tr.feed(wv, filler, st)
    tr.finish()
    assert len(tr.hits) >= 2
    assert not tr.hits[0].new_estim
    assert any(h.new_estim for h in tr.hits[1:])
    # without the flag: a single emission
    tr2 = KWSTracker(["kw"], time_pruning=4)
    tr2.feed(wv, filler, st)
    tr2.finish()
    assert len(tr2.hits) == 1


def test_write_stk_network_roundtrip(tmp_path, seeded_phonemes):
    """Generated loop network + a lattice with flags/likes round-trip
    through write_stk_network -> parse_stk_network."""
    from phnrec_tpu.io.stknet import parse_stk_network, write_stk_network

    phn_list_to_hmm_defs(seeded_phonemes, str(tmp_path / "models"), 3)
    phn_list_to_phn_loop(seeded_phonemes, str(tmp_path / "network"), "oth")
    net = parse_stk_network(str(tmp_path / "network"))
    write_stk_network(net, str(tmp_path / "net2"))
    net2 = parse_stk_network(str(tmp_path / "net2"))
    assert len(net2.nodes) == len(net.nodes)
    # node i of the original is written as I=i; re-parsed nodes may sit
    # at different list positions (created on first REFERENCE), so match
    # through the ident
    by_ident = {n.ident: n for n in net2.nodes}
    for i, a in enumerate(net.nodes):
        b = by_ident[str(i)]
        assert (a.word, a.model, a.ntype & 0xC) == \
            (b.word, b.model, b.ntype & 0xC)
        assert [str(net.nodes.index(t)) for t, _ in a.links] == \
            [t.ident for t, _ in b.links]

    slf = """\
I=0 W=!NULL
I=1 W=hello f=K v=2
I=2 W=!NULL
J=0 S=0 E=1 l=-1.5
J=1 S=1 E=2 l=-0.25
"""
    net3 = parse_stk_network(slf, is_text=True)
    write_stk_network(net3, str(tmp_path / "net3"))
    net4 = parse_stk_network(str(tmp_path / "net3"))
    assert net4.nodes[1].word == "hello"
    assert net4.nodes[1].is_sticky and net4.nodes[1].pron_var == 2
    assert net4.nodes[0].links[0][1] == -1.5
    assert net4.nodes[1].links[0][1] == -0.25


def test_device_kws_tracker_matches_host():
    """DeviceKWSTracker (LRTrace state carried in a device scan) must be
    hit-for-hit identical to the host KWSTracker, including emission
    order, the keyword-0 time-prune quirk, and the final flush."""
    from phnrec_tpu.decoder.stknet import DeviceKWSTracker, KWSTracker

    rng = np.random.default_rng(5)
    T, K = 200, 3
    filler = np.cumsum(rng.standard_normal(T)).astype(np.float32)
    word_vals = filler[:, None] + rng.standard_normal((T, K)).astype(
        np.float32) * 3.0
    start_times = np.maximum(
        0, np.arange(T)[:, None] - rng.integers(5, 40, (T, K))).astype(
        np.int64)
    word_vals[rng.random((T, K)) < 0.05] = -1e30
    keywords = [f"kw{j}" for j in range(K)]

    for tp in (40, 1e9):
        host = KWSTracker(keywords, time_pruning=tp)
        host.feed(word_vals, filler, start_times)
        host.finish()

        import jax.numpy as jnp
        dev = DeviceKWSTracker(keywords, time_pruning=tp)
        for s in range(0, T, 17):
            dev.feed_device(jnp.asarray(word_vals[s : s + 17]),
                            jnp.asarray(filler[s : s + 17]),
                            jnp.asarray(start_times[s : s + 17]))
        dev.finish()
        assert [(h.word, h.start, h.end, round(h.score, 4), h.new_estim)
                for h in dev.hits] == \
            [(h.word, h.start, h.end, round(h.score, 4), h.new_estim)
             for h in host.hits], f"tp={tp}"


def test_device_kws_tracker_sink_columns():
    """feed_sinks extracts word/filler columns inside the scan and must
    equal feed_device on pre-sliced values."""
    import jax.numpy as jnp

    from phnrec_tpu.decoder.stknet import DeviceKWSTracker

    rng = np.random.default_rng(8)
    T, S = 90, 5
    sink_val = rng.standard_normal((T, S)).astype(np.float32) * 4.0
    sink_wt = rng.integers(0, 50, (T, S)).astype(np.int32)
    ws, fs = [1, 3], 0
    kw = ["a", "b"]
    d1 = DeviceKWSTracker(kw, time_pruning=30, word_sinks=ws,
                          filler_sink=fs)
    for s in range(0, T, 13):
        d1.feed_sinks(jnp.asarray(sink_val[s : s + 13]),
                      jnp.asarray(sink_wt[s : s + 13]))
    d1.finish()
    d2 = DeviceKWSTracker(kw, time_pruning=30)
    d2.feed_device(jnp.asarray(sink_val[:, ws]),
                   jnp.asarray(sink_val[:, fs]),
                   jnp.asarray(sink_wt[:, ws]))
    d2.finish()
    assert [(h.word, h.start, h.end, round(h.score, 4)) for h in d1.hits] \
        == [(h.word, h.start, h.end, round(h.score, 4)) for h in d2.hits]
    assert d1.hits, "expected at least one hit from random walks"
