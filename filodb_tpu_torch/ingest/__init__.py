"""Ingestion transports (port of filodb_tpu/ingest/).  Importing the
package registers every built-in IngestionStream factory ('csv',
'memory', 'kafka', 'filebroker') so config-driven `create_stream(name)`
resolves without explicit imports."""
from filodb_tpu_torch.ingest import stream as _stream          # noqa: F401 csv/memory
from filodb_tpu_torch.ingest import kafka as _kafka            # noqa: F401 kafka
from filodb_tpu_torch.ingest import filebroker as _filebroker  # noqa: F401 filebroker
