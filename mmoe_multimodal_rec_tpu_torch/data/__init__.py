"""Host-side input handling: shard I/O, decoding, sentence splitting,
tokenizers, the text packer and the batch loaders, plus the offline
pipeline's modules (features, textbuild, pretokenize, minibeam,
beam_pipeline, ingest, patches, native_tokenizer)."""
from .decode import (decode_sample, image_to_patch_rows, patch_rows_to_image,
                     safe_float)
from .loader import (BatchLoader, assemble_batch, device_prefetch,
                     iter_decoded, make_eval_loader, make_train_loader,
                     split_shards)
from .packer import PackedBatch, TextPacker, pack_pair
from .sentence import make_sentence_splitter, split_sentences
from .tar_io import ShardWriter, iter_shard, write_shard
from .wordpiece import (HashTokenizer, WordPieceTokenizer, basic_tokenize,
                        load_tokenizer)

__all__ = [
    "decode_sample", "image_to_patch_rows", "patch_rows_to_image",
    "safe_float", "BatchLoader", "assemble_batch", "device_prefetch",
    "iter_decoded", "make_eval_loader", "make_train_loader", "split_shards",
    "PackedBatch", "TextPacker", "pack_pair", "make_sentence_splitter",
    "split_sentences", "ShardWriter", "iter_shard", "write_shard",
    "HashTokenizer", "WordPieceTokenizer", "basic_tokenize", "load_tokenizer",
]
