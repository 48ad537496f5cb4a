"""Set-up: from the start of the process to the window (imports, weights,
the program's build and load, kernel builds, warm-up and the checked
steps), on the host clock."""

NAME, UNIT, TRACE = "setup_s", "s", 0


def read(record):
    return record.get("setup_s")
