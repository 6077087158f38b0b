from shapy_tpu_torch.measure.measurements import (  # noqa: F401
    BodyMeasurements,
    MeasurementAnchors,
    DENSITY,
)
