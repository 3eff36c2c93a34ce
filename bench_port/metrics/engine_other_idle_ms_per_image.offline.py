"""Device-idle ms per image inside the engine calls (``engine.generate``)
and outside both factors: CLIP, the VAE decodes, the hint and the copy to
the host, in the traced window.  With the two factors' metrics it adds up
to the idle time inside the engine calls."""

from bench_port import stages


def read(rec):
    return stages.per_image(rec, ("engine.generate",),
                            minus=("chain.condition", "chain.image"))
