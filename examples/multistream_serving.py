"""Multi-stream serving: decode N concurrent audio streams per chip.

Each stream gets the exact single-stream semantics (replicate-first-frame
STC init, 15-frame delay gate, repeat-last-frame tail flush), but all N
share ONE fused block dispatch — the carried mel tails and the stream-
minor Viterbi state are batched over streams, so serving capacity scales
with the batch instead of running N processes as the reference would
(srec.cpp:793-849 is one stream per SpeechRec).

    python examples/multistream_serving.py PKG_DIR a.raw b.raw [...]

Streams may have different lengths; each file becomes one stream and the
per-stream .rec lines print at the end.  Pass --mesh to shard the stream
axis over all local devices (jax.sharding Mesh, zero collectives).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--mesh"]
    use_mesh = "--mesh" in sys.argv
    if len(args) < 2:
        print(__doc__)
        sys.exit(1)
    pkg, paths = args[0], args[1:]

    from phnrec_tpu.multistream import (MultiStreamKWS,
                                        MultiStreamRecognizer)
    from phnrec_tpu.pipeline import SpeechRec
    from phnrec_tpu.io.labels import format_rec_line

    mesh = None
    if use_mesh:
        import jax
        import numpy as np
        from jax.sharding import Mesh

        dev = jax.devices()
        n_dev = len(dev)
        while len(paths) % n_dev:
            n_dev -= 1
        mesh = Mesh(np.array(dev[:n_dev]), axis_names=("data",))
        print(f"# sharding {len(paths)} streams over {n_dev} devices")

    sr = SpeechRec(pkg)
    # KWS packages (decoder/type=stkint + mode=kws) get the multi-stream
    # keyword-spotting server; everything else the phoneme server
    kws = sr.stk_decoder is not None and sr.stk_decoder.mode == "kws"
    cls = MultiStreamKWS if kws else MultiStreamRecognizer
    ms = cls(sr, n_streams=len(paths), mesh=mesh)
    chunk = 64 * 1024
    offsets = [0] * len(paths)
    data = [open(p, "rb").read() for p in paths]
    # interleaved feeding, as concurrent sources would arrive
    while any(o < len(d) for o, d in zip(offsets, data)):
        for i, d in enumerate(data):
            if offsets[i] < len(d):
                ms.process(i, d[offsets[i] : offsets[i] + chunk])
                offsets[i] += chunk
            else:
                ms.end_stream(i)
    results = ms.finish()
    for path, labels in zip(paths, results):
        print(f"# {path}")
        for lab in labels:
            print(format_rec_line(lab))


if __name__ == "__main__":
    main()
