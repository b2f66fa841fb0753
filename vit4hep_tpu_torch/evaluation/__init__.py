"""Physics evaluation of the port: high-level features, the histogram
suite, the classifier tests, FPD/KPD and the u-space evaluation (port of
``vit4hep_tpu/evaluation``). matplotlib, h5py and sklearn are imported by
none of these modules at import time."""

from vit4hep_tpu_torch.evaluation import us_evaluation  # noqa: F401
from vit4hep_tpu_torch.evaluation.high_level_features import HighLevelFeatures  # noqa: F401
from vit4hep_tpu_torch.evaluation.ugr_evaluation import evaluate_showers, run_from_py  # noqa: F401
from vit4hep_tpu_torch.evaluation.us_evaluation import eval_ui_dists, plot_ui_dists  # noqa: F401
