"""Networks of the port: generators, discriminators and training criterions."""
from ipercore_tpu_torch.models.networks.discriminators import (  # noqa: F401
    DISCRIMINATOR_REGISTRY,
    build_discriminator,
)
from ipercore_tpu_torch.models.networks.generators import (  # noqa: F401
    GENERATOR_NAMES,
    InputConcatGenerator,
    LWBGenerator,
    ResNetInpaintor,
    TextureWarpingGenerator,
    build_generator,
)
