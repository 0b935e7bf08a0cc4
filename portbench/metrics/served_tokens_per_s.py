"""Tokens the engine served (prompt tokens taken in and tokens generated)
over all the seconds of the window."""


def read(rec):
    w = rec["window"]
    if "tokens" not in w or w["seconds"] <= 0:
        return None
    return w["tokens"] / w["seconds"]
