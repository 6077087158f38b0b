from shapy_tpu_torch.eval.metrics import (  # noqa: F401
    PointError,
    SparsePointRegressor,
    build_alignment,
    no_alignment,
    point_error,
    point_fscore,
    procrustes_align,
    root_align,
    scale_align,
    translation_align,
)
from shapy_tpu_torch.eval.evaluator import (  # noqa: F401
    Evaluator,
    build_evaluator,
)
