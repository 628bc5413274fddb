"""Dataset acquisition & preparation kit (offline, host-side): the port's
own copies of the JAX package's datasetkit/ (parsing, clip flattening,
GloVe loaders, filtering, merge, sampling, splits, statistics, topics and
the gated scraping stages), so the port never imports the JAX package.
Re-exports the parsing API as video_chapter_generation_tpu/datasetkit/
__init__.py:7-27 does.
"""

from .parsing import (
    TIMESTAMP_DELIMITER,
    clean_str,
    extract_first_timestamp,
    extract_timestamp,
    parse_csv_to_list,
    parse_timestamp_lines,
    remove_timestamp,
    text_decontracted,
)

__all__ = [
    "TIMESTAMP_DELIMITER",
    "clean_str",
    "extract_first_timestamp",
    "extract_timestamp",
    "parse_csv_to_list",
    "parse_timestamp_lines",
    "remove_timestamp",
    "text_decontracted",
]
