"""Known-good: retry's counter names enter through a keyword-only
parameter's default and a counter= keyword."""


def retry(fn, policy=None, *, label="op", counter="retries"):
    return fn()


def gather(fn):
    return retry(fn, label="gather", counter="collective_retries")
