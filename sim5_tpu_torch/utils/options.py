"""String option parsing (reference: key_value_get, sim5utils.c:255-278).

Port of `sim5_tpu/utils/options.py`, a copy."""


def key_value_get(options: str, key: str, default=None):
    """Extract `key=value` from a comma/space-separated option string."""
    if not options:
        return default
    for token in options.replace(",", " ").split():
        if "=" in token:
            k, v = token.split("=", 1)
            if k.strip() == key:
                return v.strip()
    return default
