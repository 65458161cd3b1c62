"""Batch/maintenance jobs (port of filodb_tpu/jobs; maps ref: spark-jobs/ —
DownsamplerMain lives in filodb_tpu_torch.downsample.batch_job; this
package holds the repair/migration jobs: ChunkCopier, PartitionKeysCopier,
CardinalityBuster)."""
from filodb_tpu_torch.jobs.copier import ChunkCopier, PartitionKeysCopier
from filodb_tpu_torch.jobs.buster import CardinalityBuster

__all__ = ["ChunkCopier", "PartitionKeysCopier", "CardinalityBuster"]
