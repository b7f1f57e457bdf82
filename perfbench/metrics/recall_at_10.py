"""Answer quality: the share of the float64 reference's 10 nearest ids
found, over every answer judged."""


def read(run):
    if not run.numbers.get("answers_checked"):
        return None
    return run.numbers["recall_at_10"]
