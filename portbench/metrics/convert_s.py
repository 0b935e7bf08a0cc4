"""Seconds of the offline conversion: the port's calibration pass and
table build (and for the decode its CRC record and load verification)."""


def read(rec):
    return rec["spans"].get("convert_s")
