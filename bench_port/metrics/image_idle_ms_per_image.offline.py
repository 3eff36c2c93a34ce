"""Device-idle ms per image inside the image factor's spans
(``chain.image``: the hint pyramid, initial noise and every sampler step of
the ControlNet + SD UNet at the 64^2 latent), in the traced window."""

from bench_port import stages


def read(rec):
    return stages.per_image(rec, ("chain.image",))
