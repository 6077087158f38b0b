"""The attribute models (port of ``shapy_tpu/models/attributes``): S2A
(:class:`~.b2a.B2A`, betas -> linguistic ratings), A2S
(:class:`~.a2b.A2B`, ratings + measurements -> betas), the network zoo
they are built from (:mod:`.networks`, :mod:`.polynomial`) and the
probabilistic A2S heads (:mod:`.prob`, :mod:`.prob_import`)."""

from shapy_tpu_torch.models.attributes.constants import (  # noqa: F401
    ATTRIBUTE_NAMES,
    SELF_REPORT_BIAS,
)
from shapy_tpu_torch.models.attributes.polynomial import (  # noqa: F401
    Polynomial,
)
