"""Real-pipeline throughput: mixed-length corpus -> the CLI file-list
path (SpeechRec.process_file_list -> PrefetchLoader -> bucketed batches
-> device decode -> MLF), including host I/O, padding waste, and label
formatting.

The hero bench (bench.py) measures one uniform pre-staged batch; this one
measures the production path the reference models as its serial file-list
loop (ProcessFileList, srec.cpp:1246-1291): N utterances of varied
durations read from disk, decoded with the CZ package, written to a
Master Label File.  Audio seconds are counted at TRUE lengths, so bucket
padding waste lowers the reported rate — the gap to the hero number is
the loader/bucketing overhead.

lin16 ships 16 kB per audio-second (int16 on the link, cast on device),
alaw ships raw uint8 codes (8 kB/au-s, decoded by a device table gather
exactly as srec.cpp:769).  The timed passes are INTERLEAVED A/B/A/B
(lin16, alaw, lin16, ...) and each pass is bracketed by a direct H2D
bandwidth probe (a timed device_put of a known-size buffer, int16 and
uint8 separately) — the JSON attributes each format's rate to the link
state it saw (``*_h2d_mbps``, ``*_link_eff`` = achieved au-s/s over that
phase's link-bound au-s/s).

Usage: python benchmarks/mixed_length.py [n_utts]
Prints one JSON line; also importable (run()) from bench.py.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CZ_PKG = "/root/reference/PHN_CZ_SPDAT_LCRC_N1500"
TEST_RAW = "/root/reference/test.raw"
GOLDEN_REC = "/root/reference/test.rec.org"

# deterministic mixed durations (seconds); cycled over the corpus.  Mix of
# short commands, typical utterances, and long-form clips around the 7.49 s
# source (longer ones tile it).
DURATIONS = [1.1, 7.49, 2.3, 4.7, 0.9, 9.8, 3.1, 6.2, 1.7, 12.4, 5.3, 2.9]


def _alaw_encode(sig: np.ndarray) -> np.ndarray:
    """Nearest-code A-law encoder (the optimal quantizer against the
    reference's decode table 8*ALawTableD5, srec.cpp:769)."""
    from phnrec_tpu.io.audio import ALAW_TABLE_D5

    dec = 8.0 * ALAW_TABLE_D5.astype(np.float64)
    order = np.argsort(dec)
    sd = dec[order]
    pos = np.searchsorted(sd, sig.astype(np.float64))
    pos = np.clip(pos, 1, 255)
    left, right = sd[pos - 1], sd[pos]
    take_left = (sig - left) <= (right - sig)
    idx = np.where(take_left, pos - 1, pos)
    return order[idx].astype(np.uint8)


def build_corpus(root: str, n_utts: int, fmt: str = "lin16") -> list[str]:
    """Slice/tile test.raw into n_utts raw files (idempotent)."""
    os.makedirs(root, exist_ok=True)
    src = np.frombuffer(open(TEST_RAW, "rb").read(), np.int16)
    ext = "raw" if fmt == "lin16" else "alaw"
    paths = []
    for i in range(n_utts):
        # index 0 is the intact source utterance: its decode is asserted
        # against a golden below
        dur = 7.49 if i == 0 else DURATIONS[i % len(DURATIONS)]
        n = int(dur * 8000)
        reps = -(-n // len(src))
        sig = np.tile(src, reps)[:n] if i else src
        p = os.path.join(root, f"utt_{i:05d}.{ext}")
        data = (sig.astype("<i2").tobytes() if fmt == "lin16"
                else _alaw_encode(sig).tobytes())
        if not os.path.exists(p) or os.path.getsize(p) != len(data):
            with open(p, "wb") as f:
                f.write(data)
        paths.append(p)
    return paths


def _golden_segments():
    segs = []
    for line in open(GOLDEN_REC):
        parts = line.split()
        if len(parts) >= 3:
            segs.append((int(parts[0]) // 100000, int(parts[1]) // 100000,
                         parts[2]))
    return segs


def _alaw_package(root: str) -> str:
    """CZ package clone with source/format=alaw (idempotent)."""
    pkg = os.path.join(root, "pkg_alaw")
    if not os.path.isdir(pkg):
        os.makedirs(pkg)
        for entry in os.listdir(CZ_PKG):
            if entry != "config":
                os.symlink(os.path.join(CZ_PKG, entry),
                           os.path.join(pkg, entry))
        cfg = open(os.path.join(CZ_PKG, "config")).read()
        with open(os.path.join(pkg, "config"), "w") as f:
            f.write(cfg.replace("format=lin16", "format=alaw"))
    return pkg


def _mlf_labels(mlf_path: str, stem: str):
    from phnrec_tpu.io.labels import read_mlf

    mlf = read_mlf(mlf_path)
    for name, labels in mlf.items():
        if stem in name:
            return labels
    raise KeyError(stem)


def probe_h2d(dtype, nbytes: int = 12 << 20) -> float:
    """Achieved host->device bandwidth RIGHT NOW for the given payload
    dtype, in bytes/s: one timed blocking device_put of a known-size
    buffer.  The transfer (~0.4 s at 30 MB/s) dwarfs dispatch noise, so
    a single blocking timing is sound here (unlike compute timings).
    int16 vs uint8 probes separately expose any per-ELEMENT (rather than
    per-byte) transport cost that would erase alaw's half-the-bytes
    advantage."""
    import jax

    n = nbytes // np.dtype(dtype).itemsize
    buf = np.zeros(n, dtype)
    t0 = time.perf_counter()
    jax.device_put(buf).block_until_ready()
    return nbytes / (time.perf_counter() - t0)


def _one_pass(sr, lst: str, tag: str, it: int) -> float:
    """One timed process_file_list pass -> seconds."""
    t0 = time.perf_counter()
    sr.process_file_list("wf", "str", lst,
                         mlf_path=f"/tmp/phnrec_mixed_{tag}_{it}.mlf")
    return time.perf_counter() - t0


def run(n_utts: int = 1024, iters: int = 3) -> dict:
    import gc

    from phnrec_tpu.pipeline import SpeechRec

    golden = _golden_segments()

    # -- lin16 corpus + recognizer
    corpus = build_corpus("/tmp/phnrec_mixed_corpus", n_utts)
    sr_l = SpeechRec(CZ_PKG)
    lst_l = "/tmp/phnrec_mixed_lin16.list"
    with open(lst_l, "w") as f:
        f.write("\n".join(corpus) + "\n")
    audio_l = sum(os.path.getsize(p) for p in corpus) / 2.0 / 8000.0

    def check_lin16(mlf_path):
        got = [(l.start_frames, l.end_frames, l.name)
               for l in _mlf_labels(mlf_path, "utt_00000")]
        assert got == golden, "mixed-length decode lost golden"

    # -- alaw corpus + recognizer
    corpus_a = build_corpus("/tmp/phnrec_mixed_corpus_alaw", n_utts,
                            fmt="alaw")
    sr_a = SpeechRec(_alaw_package("/tmp/phnrec_mixed_corpus_alaw"))
    lst_a = "/tmp/phnrec_mixed_alaw.list"
    with open(lst_a, "w") as f:
        f.write("\n".join(corpus_a) + "\n")
    audio_a = sum(os.path.getsize(p) for p in corpus_a) / 8000.0
    # anchor: the batched path must equal the serial path on the SAME
    # alaw bytes (alaw encoding is lossy, so the lin16 golden does not
    # transfer; path equivalence is the invariant)
    want_a = [(l.start_frames, l.end_frames, l.name)
              for l in sr_a.process_offline(
                  "wf", "str", open(corpus_a[0], "rb").read()).labels]

    def check_alaw(mlf_path):
        got = [(l.start_frames, l.end_frames, l.name)
               for l in _mlf_labels(mlf_path, "utt_00000")]
        assert got == want_a, "alaw batched decode diverged from serial"

    # warm both paths (compiles + file cache), golden-check each
    _one_pass(sr_l, lst_l, "lin16", 99)
    check_lin16("/tmp/phnrec_mixed_lin16_99.mlf")
    _one_pass(sr_a, lst_a, "alaw", 99)
    check_alaw("/tmp/phnrec_mixed_alaw_99.mlf")

    # link-bound au-s/s per achieved link byte/s: lin16 ships 2 B/sample,
    # alaw 1 B/sample, both at 8 kHz
    bound_per_bps = {"lin16": 1.0 / 16000.0, "alaw": 1.0 / 8000.0}
    times = {"lin16": [], "alaw": []}
    h2d = {"lin16": [], "alaw": []}
    eff = {"lin16": [], "alaw": []}
    gc.disable()
    try:
        # INTERLEAVED A/B passes so link variation hits both formats
        # alike; each pass bracketed by a same-dtype H2D probe
        for it in range(iters):
            for tag, sr, lst, audio_s, dtype in (
                    ("lin16", sr_l, lst_l, audio_l, np.int16),
                    ("alaw", sr_a, lst_a, audio_a, np.uint8)):
                bw = probe_h2d(dtype)
                dt = _one_pass(sr, lst, tag, it)
                times[tag].append(audio_s / dt)
                h2d[tag].append(bw)
                eff[tag].append((audio_s / dt)
                                / (bw * bound_per_bps[tag]))
    finally:
        gc.enable()
    check_lin16(f"/tmp/phnrec_mixed_lin16_{iters - 1}.mlf")
    check_alaw(f"/tmp/phnrec_mixed_alaw_{iters - 1}.mlf")

    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    value, value_a = med(times["lin16"]), med(times["alaw"])
    from bench import BASELINE_AUDIO_SEC_PER_S
    return {
        "metric": "audio_sec_per_s_per_chip_mixed_corpus_to_mlf",
        "value": round(value, 2),
        "unit": "audio-seconds/s/chip",
        "vs_baseline": round(value / BASELINE_AUDIO_SEC_PER_S, 2),
        "value_best": round(max(times["lin16"]), 2),
        "alaw_value": round(value_a, 2),
        "alaw_value_best": round(max(times["alaw"]), 2),
        "alaw_vs_lin16": round(value_a / value, 2),
        # attribution: the link state each phase actually saw, and how
        # close each format ran to ITS link bound at that bandwidth
        "lin16_h2d_mbps": [round(b / 1e6, 1) for b in h2d["lin16"]],
        "alaw_h2d_mbps": [round(b / 1e6, 1) for b in h2d["alaw"]],
        "lin16_link_eff": [round(e, 2) for e in eff["lin16"]],
        "alaw_link_eff": [round(e, 2) for e in eff["alaw"]],
    }


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    print(json.dumps(run(n)))
