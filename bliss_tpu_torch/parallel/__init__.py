"""Splitting one piece of work over shards (counterpart of
bliss_tpu/parallel/). So far: `longsong`, the time-sharded analyzer of one
very long song, with its shards on one card."""
