"""Known-bad: a keyword-only counter default naming an undeclared metric
(and the declared one planted nowhere)."""


def retry(fn, policy=None, *, label="op", counter="retrys"):
    return fn()
