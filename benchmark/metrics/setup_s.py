"""setup_s: process start to the first timed frame (s): imports, the
extension loaded (or built), the scene built and uploaded, the warm-up."""


def read(records: dict):
    return records["setup_s"]
