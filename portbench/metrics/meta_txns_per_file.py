"""Write transactions of the sqlite meta engine a file committed in the
window: the count of `meta.txn.commit` (one an attempt whose BEGIN
succeeded) over the files the driver committed."""


def read(rec):
    commits = rec["stages"].get("meta.txn.commit")
    files = rec["window"].get("files", 0)
    if commits is None or files <= 0:
        return None
    return commits["count"] / files
