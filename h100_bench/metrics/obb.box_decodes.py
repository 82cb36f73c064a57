"""The port's ``obb.box_decode`` count (rows resolved by the deferred DFL
box decode, ``B * k`` a call) made inside ``Detect.infer``, a batch over
the batch size (traced batches): the candidates an image decoded, where a
full decode would take every position.  A port without the counter is
left out."""

from h100_bench import spans


def read(record):
    per_batch = spans.counted_per(record, "detect", "obb.box_decode")
    if not per_batch:
        return None
    return per_batch * record["batches"] / record["images"]
