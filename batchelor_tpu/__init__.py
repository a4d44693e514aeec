"""batchelor_tpu: single-cell batch correction (MNN family) in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the
Bioconductor batchelor package:
cosine/multi-batch normalization, weighted multi-batch PCA (exact
Gram-matrix eigendecomposition), fastMNN, classic mnnCorrect, clusterMNN,
linear baselines, diagnostics, a typed dispatch API, an out-of-core CSR
store with a C++ host runtime, per-merge-step checkpointing, and SPMD
execution over device meshes.

Orientation convention: cells are rows everywhere (N x G), 0-based indices.
"""

from .ops.cosine_norm import cosine_norm, apply_cosine_norm
from .ops.pca import multi_batch_pca, MultiBatchPCAResult
from .ops.knn import query_knn
from .ops.mutual_nn import find_mutual_nn, choose_k
from .ops.normalization import multi_batch_norm, MultiBatchNormResult
from .ops.stats import model_gene_var, combine_var, get_top_hvgs
from .ops.correction import (
    tricube_average,
    average_correction,
    center_along_batch_vector,
)
from .correct.fast_mnn import fast_mnn, reduced_mnn, MNNResult, MergeStepInfo
from .parallel.driver import distributed_fast_mnn
from .parallel.mesh import make_cells_mesh
from .correct.classic_mnn import mnn_correct
from .correct.cluster_mnn import cluster_mnn, cluster_mnn_csr, ClusterMNNResult
from .correct.linear import (
    rescale_batches,
    regress_batches,
    no_correct,
    LinearCorrectionResult,
)
from .correct.dispatch import (
    batch_correct,
    register_correction,
    BatchelorParams,
    FastMNNParams,
    ClassicMNNParams,
    RescaleParams,
    RegressParams,
    NoCorrectParams,
)
from .correct.diagnostics import (
    mnn_delta_variance,
    mnn_delta_variance_blocked,
    cluster_abundance_test,
    cluster_abundance_var,
    fit_trend_var,
)
from .correct.experiments import (
    SingleCellDataset,
    correct_experiments,
    quick_correct,
    apply_multi,
)
from .ops.lowrank import LowRankOp
from .correct.fused import fused_merge_step
from .correct.outofcore import (
    quick_correct_csr,
    rescale_batches_csr,
    regress_batches_csr,
    mnn_correct_csr,
    CSRResidualOp,
)
from .io.csr import CSRCells, dense_blocks, device_dense_blocks
from .io.checkpoint import MergeCheckpointer, save_pca_stage, load_pca_stage
from .utils.batching import (
    divide_into_batches,
    restore_original_order,
    reindex_pairings,
    intersect_rows,
    check_batch_consistency,
    check_restrictions,
)
from .utils.telemetry import MetricsRecorder, trace_span

__version__ = "0.1.0"
