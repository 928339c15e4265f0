"""A miniature metric registry."""

METRIC_DESCRIPTIONS = {
    "retries": "transient failures retried by faults.retry",
}
