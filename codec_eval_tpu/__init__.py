"""codec-eval-tpu: accelerator-native image-codec quality evaluation framework.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
``codec-eval`` Rust workspace (see SURVEY.md): callback-based codec
evaluation sessions, perceptual metrics (SSIMULACRA2, DSSIM, Butteraugli,
PSNR) as fused device kernels, viewing-condition modelling, rate-distortion
analytics (Pareto fronts, BD-rate, R-D knees), corpus management, CSV
import, and reporting — with the scoring grid sharded over a device
mesh.

The public surface mirrors the reference crate root re-exports
(reference: src/lib.rs:40-107).
"""

__version__ = "0.1.0"

from .engine import (  # noqa: F401
    BatchScorer,
    CodecResult,
    CorpusReport,
    EncodeRequest,
    EvalConfig,
    EvalConfigBuilder,
    EvalSession,
    ImageData,
    ImageReport,
    assert_perception_level,
    assert_quality,
    evaluate_single,
)
from .errors import (  # noqa: F401
    CodecError,
    CodecEvalError,
    DimensionMismatch,
    QualityBelowThreshold,
)
from .metrics import MetricConfig, MetricResult, PerceptionLevel  # noqa: F401
from .stats.pareto import ParetoFront, RDPoint  # noqa: F401
from .stats.summary import (  # noqa: F401
    Summary,
    bd_rate,
    iqr,
    mean,
    median,
    percentile,
    percentile_u32,
    std_dev,
    trimmed_mean,
)
from .viewing import (  # noqa: F401
    REFERENCE_PPD,
    SimulationMode,
    SimulationParams,
    ViewingCondition,
    presets,
)


def xyb_roundtrip(rgb_u8, width=None, height=None):
    """sRGB u8 -> quantized-XYB -> sRGB u8 roundtrip (device kernel).

    Accepts an (H, W, 3) array, or flat bytes plus width/height for parity
    with the reference signature (reference: src/metrics/xyb.rs:225).
    """
    import numpy as np

    from .kernels import color as _kc

    if width is not None:
        arr = np.frombuffer(bytes(rgb_u8), dtype=np.uint8).reshape(height, width, 3)
        return np.asarray(_kc.xyb_roundtrip(arr)).reshape(-1).tobytes()
    return np.asarray(_kc.xyb_roundtrip(np.asarray(rgb_u8)))
