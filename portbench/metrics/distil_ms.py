"""distil_ms.train: device milliseconds of span train.secondary per
distillation iteration."""


def read(reading, suffix):
    if suffix != "train" or reading is None or reading.get("kind") != "train" \
            or not reading["distils"]:
        return None
    s = reading["timeline"].span_device_s("train.secondary")
    return None if s is None else s * 1e3 / reading["distils"]
