import datetime


def iso_utc(unix_s: float) -> str:
    """Unix seconds -> RFC3339 UTC with the 'Z' suffix Prometheus
    payloads use (isoformat emits '+00:00')."""
    return datetime.datetime.fromtimestamp(
        unix_s, datetime.timezone.utc).isoformat().replace("+00:00", "Z")
