"""Seeded model packages and audio, so the whole system runs without the
shipped model packages.

``write_package`` writes a complete LCRC package in the reference's own
layout and formats: ``weights/{band0,band1,merger}.nbin`` (weights with
their input norms, io/weights.save_nbin), ``windows/band{0,1}.window``,
``dicts/phonemes`` and ``config``.  The default widths are those of the
CZ SpeechDat N1500 package (SURVEY.md section 6): 8 kHz, 15 mel banks
over 64-4000 Hz, frame 200 / hop 80, LCRC length 31 with C0, band nets
165->1500->138, merger 276->1500->138, 45 phonemes plus the ``oth``
garbage class (x 3 states = 138 outputs), phndec with wpenalty -4.6875
and time_pruning 40, sentence mean norm on, HMMs generated from the
phoneme list.

Weights are Gaussian, scaled by 1/sqrt(fan_in).  The input norms are
estimated, as a trained package's are, from data: the package's own
features of seeded calibration audio (computed on the CPU), so every
net sees unit-variance inputs and the posteriors are far from uniform.

``waveform`` makes seeded int16 speech-like audio: piecewise-stationary
segments of amplitude-modulated harmonics under two formant peaks,
unvoiced noise bursts and pauses, over a noise floor.  ``write_kws_files``
adds a seeded keyword list and lexicon over the synthetic phonemes.

    python -m phnrec_tpu.synth OUT_DIR [--seed N] [--decoder phndec|stkint|kws]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from phnrec_tpu.io.weights import MLPParams, save_nbin


@dataclass(frozen=True)
class PackageSpec:
    sample_freq: int = 8000
    nbanks: int = 15
    lower_freq: float = 64.0
    higher_freq: float = 4000.0
    vector_size: int = 200
    vector_step: int = 80
    trap_len: int = 31
    n_coefs: int = 11             # C0 + DCT_1..10 per bank (add_c0=true)
    n_hidden: int = 1500
    n_phonemes: int = 45          # the nets add one garbage class (oth)
    n_states: int = 3
    wpenalty: float = -4.6875
    time_pruning: int = 40
    sent_mean_norm: bool = True

    @property
    def n_out(self) -> int:
        return (self.n_phonemes + 1) * self.n_states

    @property
    def band_inputs(self) -> int:
        return self.nbanks * self.n_coefs


CZ_N1500 = PackageSpec()

# calibration audio for the input norms: utterances x seconds
_CALIB = (4, 4.0)


def phonemes(n: int) -> List[str]:
    return [f"p{i:02d}" for i in range(n)]


def waveform(seed, seconds: float, sample_freq: int = 8000) -> np.ndarray:
    """Seeded int16 speech-like waveform of ``seconds`` seconds."""
    rng = np.random.default_rng(seed)
    fs = float(sample_freq)
    n = int(round(seconds * fs))
    durs = rng.uniform(0.05, 0.25, size=int(seconds / 0.05) + 2)
    bounds = np.cumsum((durs * fs).astype(np.int64))
    seg = np.searchsorted(bounds, np.arange(n), side="right")
    n_seg = int(seg[-1]) + 1 if n else 0
    kind = rng.choice(3, size=n_seg, p=[0.7, 0.15, 0.15])  # voiced/noise/pause
    f0 = rng.uniform(80.0, 250.0, n_seg)
    f1 = rng.uniform(300.0, 900.0, n_seg)
    f2 = rng.uniform(900.0, 2800.0, n_seg)
    amp = rng.uniform(0.3, 1.0, n_seg)
    k = np.arange(1, 17)
    hf = f0[:, None] * k[None, :]                                # [seg, K]
    gain = (np.exp(-((hf - f1[:, None]) / 150.0) ** 2)
            + 0.6 * np.exp(-((hf - f2[:, None]) / 250.0) ** 2) + 0.03)
    gain = np.where(hf < 0.48 * fs, gain, 0.0)
    phase = 2.0 * np.pi * np.cumsum(f0[seg]) / fs
    voiced = np.zeros(n)
    for j in range(k.size):
        voiced += gain[seg, j] * np.sin(k[j] * phase)
    noise = rng.standard_normal(n)
    t = np.arange(n) / fs
    env = amp[seg] * (0.65 + 0.35 * np.sin(2.0 * np.pi * 4.0 * t
                                           + rng.uniform(0, 2 * np.pi)))
    sig = np.where(kind[seg] == 0, voiced, np.where(kind[seg] == 1,
                                                     0.8 * noise, 0.0))
    out = 6000.0 * env * sig + 20.0 * rng.standard_normal(n)
    return np.clip(np.round(out), -32768, 32767).astype(np.int16)


def _net(rng, n_inp: int, n_hid: int, n_out: int) -> MLPParams:
    w1 = rng.standard_normal((n_hid, n_inp)) / np.sqrt(n_inp)
    # output logits of several units' spread; the bias cancels the mean
    # drive of the sigmoid hidden layer (h ~ 0.5) so no class dominates
    w2 = 10.0 * rng.standard_normal((n_out, n_hid)) / np.sqrt(n_hid)
    return MLPParams(
        w1=w1.astype(np.float32),
        b1=(0.1 * rng.standard_normal(n_hid)).astype(np.float32),
        w2=w2.astype(np.float32),
        b2=(-0.5 * w2.sum(axis=1)).astype(np.float32),
        mean=np.zeros(n_inp, np.float32),
        dev=np.ones(n_inp, np.float32))


def _set_norms(p: MLPParams, x: np.ndarray) -> MLPParams:
    """Input norms from data: mean, and dev = 1/std (nn.cpp:702-716)."""
    std = np.maximum(x.std(axis=0), 1e-3)
    return dataclasses.replace(p, mean=x.mean(axis=0).astype(np.float32),
                               dev=(1.0 / std).astype(np.float32))


def _config(spec: PackageSpec, decoder: str) -> str:
    dec = {
        "phndec": "type=phndec\n",
        "stkint": "type=stkint\nmode=decode\n",
        "kws": "type=stkint\nmode=kws\n",
    }[decoder]
    nets = {
        "phndec": "gen_phn_loop=true\ndefault=$T/network\n",
        "stkint": "gen_phn_loop=true\ndefault=$T/network\n",
        "kws": "gen_kws_net=true\ndefault=$T/kwsnet\n",
    }[decoder]
    dicts = "phoneme_list=$C/dicts/phonemes\n"
    if decoder == "kws":
        dicts += ("keyword_list=$C/dicts/keywords\n"
                  "lexicon1=$C/dicts/lexicon\n")
    onoff = "true" if spec.sent_mean_norm else "false"
    return (
        f"[source]\nformat=lin16\nsample_freq={spec.sample_freq}\n"
        f"[melbanks]\nnbanks={spec.nbanks}\nlower_freq={spec.lower_freq:g}\n"
        f"higher_freq={spec.higher_freq:g}\nvector_size={spec.vector_size}\n"
        f"vector_step={spec.vector_step}\n"
        f"[offlinenorm]\nsent_mean_norm={onoff}\n"
        f"[posteriors]\nenabled=true\nsystem=LCRC\nlength={spec.trap_len}\n"
        "add_c0=true\nhamming=false\nbunch_size=5\n"
        "softening_func=none 0 0 0\n"
        f"[decoder]\n{dec}num_states_per_phn={spec.n_states}\n"
        f"wpenalty={spec.wpenalty}\ntime_pruning={spec.time_pruning}\n"
        "softening_func=log 0 0 0\n"
        f"[models]\ngen_from_phn_list=true\nnstates={spec.n_states}\n"
        f"[networks]\n{nets}"
        f"[dicts]\n{dicts}")


def write_kws_files(root: str, seed: int, names: Sequence[str],
                    n_keywords: int = 4) -> List[str]:
    """Seeded keyword list + lexicon (``word<TAB>phones``) in dicts/."""
    rng = np.random.default_rng([seed, 7])
    words = [f"kw{i:02d}" for i in range(n_keywords)]
    lines = []
    for w in words:
        prons = rng.choice(len(names), size=int(rng.integers(3, 6)),
                           replace=False)
        lines.append(f"{w}\t{' '.join(names[i] for i in prons)}\n")
    d = os.path.join(root, "dicts")
    with open(os.path.join(d, "keywords"), "w") as f:
        f.write("".join(w + "\n" for w in words))
    with open(os.path.join(d, "lexicon"), "w") as f:
        f.write("".join(lines))
    return words


def write_package(root: str, seed: int = 0, spec: PackageSpec = CZ_N1500,
                  decoder: str = "phndec") -> str:
    """Write a seeded LCRC model package into ``root``; returns ``root``.

    ``decoder``: ``phndec`` (the CZ package's phoneme loop), ``stkint``
    (network decoder over the generated phoneme loop) or ``kws`` (keyword
    spotting over a seeded keyword list).  Only the config and dicts
    differ between them; the nets depend on ``seed`` and ``spec`` alone.
    """
    import jax

    from phnrec_tpu.frontend.melbanks import MelFrontend, MelSpec
    from phnrec_tpu import reference

    for sub in ("weights", "windows", "dicts"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = phonemes(spec.n_phonemes)
    with open(os.path.join(root, "dicts", "phonemes"), "w") as f:
        f.write("".join(p + "\n" for p in names))
    if decoder == "kws":
        write_kws_files(root, seed, names)
    with open(os.path.join(root, "config"), "w") as f:
        f.write(_config(spec, decoder))

    # LCRC windows: the rising and falling halves of a Hamming window
    ham = np.hamming(spec.trap_len)
    hc = (spec.trap_len - 1) // 2 + 1
    for i, win in enumerate((ham[:hc], ham[hc - 1:])):
        with open(os.path.join(root, "windows", f"band{i}.window"), "w") as f:
            f.write(" ".join(f"{v:.8e}" for v in win) + "\n")

    rng = np.random.default_rng([seed, 1])
    bands = [_net(rng, spec.band_inputs, spec.n_hidden, spec.n_out)
             for _ in range(2)]
    merger = _net(rng, 2 * spec.n_out, spec.n_hidden, spec.n_out)

    # norms from the package's own features of seeded calibration audio,
    # computed on the CPU with the plain reference
    model = reference.ReferenceModel(
        *bands, merger, win_left=ham[:hc].astype(np.float32),
        win_right=ham[hc - 1:].astype(np.float32), trap_len=spec.trap_len,
        add_c0=True, sent_mean_norm=spec.sent_mean_norm)
    fe = MelFrontend(MelSpec(
        sample_freq=spec.sample_freq, vector_size=spec.vector_size,
        step=spec.vector_step, nbanks=spec.nbanks,
        lo_freq=spec.lower_freq, hi_freq=spec.higher_freq))
    n_utts, secs = _CALIB
    with jax.default_device(jax.devices("cpu")[0]):
        feats, ins = [], []
        for u in range(n_utts):
            wave = waveform([seed, 2, u], secs, spec.sample_freq)
            par = np.asarray(fe(wave.astype(np.float32),
                                fe.frame_count(wave.size)))
            if spec.sent_mean_norm:
                par = par - par.mean(axis=0, keepdims=True)
            feats.append(par)
        for i, side in enumerate(zip(*(
                reference.lcrc_features(p, model, spec.n_coefs)
                for p in feats))):
            bands[i] = _set_norms(bands[i], np.concatenate(
                [np.asarray(s) for s in side]))
        for p in feats:
            left, right = reference.lcrc_features(p, model, spec.n_coefs)
            m = np.concatenate(
                [np.asarray(reference.mlp_posteriors(bands[0], left)),
                 np.asarray(reference.mlp_posteriors(bands[1], right))],
                axis=-1)
            ins.append(np.where(m > 0, np.log(np.maximum(m, 1e-37)), 0.0))
        merger = _set_norms(merger, np.concatenate(ins))

    for name, p in (("band0", bands[0]), ("band1", bands[1]),
                    ("merger", merger)):
        save_nbin(os.path.join(root, "weights", f"{name}.nbin"), p)
    return root


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decoder", choices=("phndec", "stkint", "kws"),
                    default="phndec")
    ap.add_argument("--audio-seconds", type=float, default=0.0,
                    help="also write OUT_DIR/audio.raw (lin16) of this "
                         "length")
    a = ap.parse_args(argv)
    write_package(a.out_dir, a.seed, decoder=a.decoder)
    if a.audio_seconds > 0:
        waveform([a.seed, 3], a.audio_seconds).tofile(
            os.path.join(a.out_dir, "audio.raw"))


if __name__ == "__main__":
    main()
