"""Batch decoding: a directory/list of waveforms -> .rec label files.

The batched replacement for `phnrec -c DIR -l list.scp` — utterances
are padded into one [B, L] tensor and the whole wav->labels pipeline runs
as a single jitted program (parallel/batch.py), optionally sharded over a
device mesh.

    python examples/batch_decode.py PKG_DIR out_dir wav1 [wav2 ...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    if len(sys.argv) < 4:
        print(__doc__)
        sys.exit(1)
    pkg, out_dir, *wavs = sys.argv[1:]
    os.makedirs(out_dir, exist_ok=True)

    from phnrec_tpu.io import audio
    from phnrec_tpu.io.labels import write_rec
    from phnrec_tpu.parallel.batch import BatchPipeline
    from phnrec_tpu.pipeline import SpeechRec

    sr = SpeechRec(pkg)
    bp = BatchPipeline(sr)
    waves = [audio.convert_waveform(audio.load_waveform_bytes(w),
                                    sr.wave_format)[0] for w in wavs]
    result = bp.run(waves)
    for path, labels in zip(wavs, result.labels):
        tgt = os.path.join(
            out_dir, os.path.splitext(os.path.basename(path))[0] + ".rec")
        write_rec(tgt, labels)
        print(f"{path} -> {tgt} ({len(labels)} segments)")


if __name__ == "__main__":
    main()
