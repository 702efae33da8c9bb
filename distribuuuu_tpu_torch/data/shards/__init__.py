"""The image shards format, ``DATA.FORMAT shards`` (counterpart of
distribuuuu_tpu/data/shards/).

``format.py`` is the on-disk contract (CRC'd length-prefixed records, an
index footer a shard, a ``MANIFEST.json`` committed last), ``order.py``
the ``(seed, epoch)``-only window-shuffled order that makes the exact
mid-epoch resume's cursor mean the same at any world size, ``reader.py``
the dataset the loader consumes and ``pack.py`` the packer:
``python -m distribuuuu_tpu_torch.data.shards.pack --src <imagefolder root>
--out <shards root> [--verify]``.
"""

from distribuuuu_tpu_torch.data.shards.format import (  # noqa: F401
    MANIFEST_NAME,
    ShardFormatError,
    ShardReadError,
    ShardWriter,
    pack_imagefolder,
    read_shard_index,
    read_shard_manifest,
    verify_split,
    write_shard_manifest,
)
from distribuuuu_tpu_torch.data.shards.order import (  # noqa: F401
    WindowShuffleSampler,
    global_order,
)
from distribuuuu_tpu_torch.data.shards.reader import RecordShards, ShardDataset  # noqa: F401
