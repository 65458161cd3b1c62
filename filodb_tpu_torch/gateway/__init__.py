from filodb_tpu_torch.gateway.influx import (InfluxRecord, parse_influx_line,
                                       influx_lines_to_batches)
from filodb_tpu_torch.gateway.router import split_batch_by_shard, GatewayPipeline

__all__ = ["InfluxRecord", "parse_influx_line", "influx_lines_to_batches",
           "split_batch_by_shard", "GatewayPipeline"]
