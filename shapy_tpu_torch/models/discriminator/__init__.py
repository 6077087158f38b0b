from shapy_tpu_torch.models.discriminator.build import (  # noqa: F401
    HMRDiscriminator,
    PoseDiscriminator,
    build_discriminator,
)
