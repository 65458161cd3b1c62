"""Ingestion transports (port of filodb_tpu/ingest/).  Importing the
package registers the built-in IngestionStream factories ('csv' and
'memory') so config-driven `create_stream(name)` resolves without
explicit imports.  The file broker, the generator and Kafka are not
ported yet."""
from filodb_tpu_torch.ingest import stream as _stream    # noqa: F401 csv/memory
