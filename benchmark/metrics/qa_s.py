"""The QA stage's seconds a question (``StageTimer``, each stage ended by a
synchronize, so device work counts)."""


def read(record):
    c = record.get("counters") or {}
    if not c.get("questions"):
        return None
    return c["qa_s"] / c["questions"]
