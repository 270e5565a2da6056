"""commit_entries_per_s: log entries committed across all groups from
the window's first tick to its last drained commit row, over the
window's length."""


def read(ctx):
    if "committed" not in ctx or ctx["window_s"] <= 0:
        return None
    return ctx["committed"] / ctx["window_s"]
