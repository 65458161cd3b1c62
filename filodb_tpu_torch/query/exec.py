"""The exec framework's facade (port of filodb_tpu/query/exec.py): one
import path for the plan nodes, transformers and data shapes the port
has.  The implementation lives in execbase, transformers, leafexec,
nonleaf and metaexec."""
from filodb_tpu_torch.core.index import ColumnFilter, Equals  # noqa: F401
from filodb_tpu_torch.ops.timewindow import (  # noqa: F401
    PAD_TS, make_window_ends, to_offsets)
from filodb_tpu_torch.query.execbase import (  # noqa: F401
    AggPartial, AnalyzeRecorder, EmptyResultExec, ExecPlan,
    GroupCardinalityError, InProcessPlanDispatcher, LazyKeys, LeafExecPlan,
    NonLeafExecPlan, PlanDispatcher, QueryError, RawBlock, ScalarResult,
    present_partial, reduce_partials)
from filodb_tpu_torch.query.leafexec import (  # noqa: F401
    MultiSchemaPartitionsExec, ScalarBinaryOperationExec,
    ScalarFixedDoubleExec, SelectPersistedSegmentsExec,
    TimeScalarGeneratorExec)
from filodb_tpu_torch.query.metaexec import (  # noqa: F401
    LabelValuesExec, MetadataMergeExec, PartKeysExec, SelectChunkInfosExec)
from filodb_tpu_torch.query.nonleaf import (  # noqa: F401
    BinaryJoinExec, DistConcatExec, LocalPartitionDistConcatExec,
    ReduceAggregateExec, RemoteAggregateExec, SetOperatorExec,
    StitchRvsExec, SubqueryExec)
from filodb_tpu_torch.query.rangevector import (  # noqa: F401
    QueryContext, QueryResult, QueryStats, RangeVectorKey, ResultBlock,
    concat_blocks, remove_nan_series)
from filodb_tpu_torch.query.transformers import (  # noqa: F401
    AbsentFunctionMapper, AggregateMapReduce, AggregatePresenter,
    InstantVectorFunctionMapper, LimitFunctionMapper,
    MiscellaneousFunctionMapper, PeriodicSamplesMapper,
    RangeVectorTransformer, RepeatToGridMapper, ScalarFunctionMapper,
    ScalarOperationMapper, SortFunctionMapper, VectorFunctionMapper)
