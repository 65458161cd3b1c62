"""Downsample runtime (port of filodb_tpu/downsample/): chunk
downsamplers, the streaming shard downsampler, the query-only downsampled
store and its planner, and the batch rollup jobs (maps ref:
core/.../downsample/ + spark-jobs/.../downsampler/).  The rollups are
host numpy, as in the reference; a downsampled store answers on its
device through its shards' DeviceMirrors.  The distributed job is
`downsample.dist_job` (its workers run as
`python -m filodb_tpu_torch.downsample.dist_job`), not imported here."""
from filodb_tpu_torch.downsample.downsamplers import (DownsamplerSpec,
                                                      downsample_chunk,
                                                      downsample_column,
                                                      parse_period_marker,
                                                      period_boundaries)
from filodb_tpu_torch.downsample.shard_downsampler import (DEFAULT_RESOLUTIONS,
                                                           ShardDownsampler)
from filodb_tpu_torch.downsample.store import (DownsampleClusterPlanner,
                                               DownsampledTimeSeriesStore,
                                               ds_dataset_name)
from filodb_tpu_torch.downsample.batch_job import DownsamplerJob, DownsampleJobStats

__all__ = [
    "DownsamplerSpec", "downsample_chunk", "downsample_column",
    "parse_period_marker", "period_boundaries", "ShardDownsampler",
    "DEFAULT_RESOLUTIONS", "DownsampledTimeSeriesStore",
    "DownsampleClusterPlanner", "ds_dataset_name", "DownsamplerJob",
    "DownsampleJobStats",
]
