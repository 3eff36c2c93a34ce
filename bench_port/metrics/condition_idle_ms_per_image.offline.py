"""Device-idle ms per image inside the condition factor's spans
(``chain.condition``: its initial noise and every sampler step of the SD
UNet + adapter at the 32^2 latent), in the traced window."""

from bench_port import stages


def read(rec):
    return stages.per_image(rec, ("chain.condition",))
