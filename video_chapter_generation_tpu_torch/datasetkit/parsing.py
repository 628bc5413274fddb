"""Timestamp / CSV / text parsing utilities for the YouTube chapter dataset.

The port's own copy of video_chapter_generation_tpu/datasetkit/parsing.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import re
from typing import List, Sequence, Tuple


TIMESTAMP_DELIMITER = "%^&*"


_TS_PATTERNS = (
    r"\d{2}:\d{2}:\d{2}",
    r"\d{1}:\d{2}:\d{2}",
    r"\d{2}:\d{2}",
    r"\d{1}:\d{2}",
)


def extract_timestamp(s: str) -> Tuple[str, int, int, int]:
    """Find the first timestamp-like substring in ``s``.

    Returns ``(timestamp_str, seconds, start_idx, end_idx)``; seconds is -1
    when no timestamp is present.


    Copied from video_chapter_generation_tpu/datasetkit/parsing.py:29.
    """
    for pat in _TS_PATTERNS:
        r = re.search(pat, s)
        if r:
            si, ei = r.regs[0]
            break
    else:
        return "", -1, -1, -1

    ts = s[si:ei].split(":")
    ts.reverse()
    sec = 0
    for i, part in enumerate(ts):
        sec += int(part) * (60**i)
    return s[si:ei], sec, si, ei


def extract_first_timestamp(s: str) -> Tuple[int, str]:
    """Return (earliest timestamp in seconds, text with ALL timestamps removed).

    A chapter line may contain several timestamps (e.g. ranges "7:08-11:31");
    the smallest is the chapter start, and the description is the line with
    every timestamp stripped.


    Copied from video_chapter_generation_tpu/datasetkit/parsing.py:51.
    """
    _, sec, si, ei = extract_timestamp(s)
    min_sec = sec
    description = s[:si] + s[ei:] if sec != -1 else s

    while sec != -1:
        _, sec, si, ei = extract_timestamp(description)
        if sec != -1:
            if min_sec > sec:
                min_sec = sec
            description = description[:si] + description[ei:]

    return min_sec, description


def remove_timestamp(s: str) -> str:
    """Remove the first timestamp from ``s`` and re-split whitespace.

    Copied from video_chapter_generation_tpu/datasetkit/parsing.py:72.
    """
    for pat in _TS_PATTERNS:
        r = re.search(pat, s)
        if r:
            si, ei = r.regs[0]
            break
    else:
        return s
    ss = s[:si] + s[ei:]
    return " ".join(x for x in ss.split(" ") if len(x) > 0)


def clean_str(s: str) -> str:
    """Strip non-alphanumeric characters from both ends of a chapter title.

    Copied from video_chapter_generation_tpu/datasetkit/parsing.py:85.
    """
    start_idx = 0
    for i in range(len(s)):
        if s[i].isalnum():
            start_idx = i
            break
    end_idx = len(s)
    for i in reversed(range(len(s))):
        if s[i].isalnum():
            end_idx = i + 1
            break
    return s[start_idx:end_idx]


def text_decontracted(phrase: str) -> str:
    """Expand English contractions ("won't" -> "will not", ...).

    Copied from video_chapter_generation_tpu/datasetkit/parsing.py:100.
    """
    phrase = re.sub(r"won't", "will not", phrase)
    phrase = re.sub(r"can\'t", "can not", phrase)
    phrase = re.sub(r"let\'s", "let us", phrase)

    phrase = re.sub(r"n\'t", " not", phrase)
    phrase = re.sub(r"\'re", " are", phrase)
    phrase = re.sub(r"t\'s", "t us", phrase)
    phrase = re.sub(r"\'s", " is", phrase)
    phrase = re.sub(r"\'d", " would", phrase)
    phrase = re.sub(r"\'ll", " will", phrase)
    phrase = re.sub(r"\'t", " not", phrase)
    phrase = re.sub(r"\'ve", " have", phrase)
    phrase = re.sub(r"\'m", " am", phrase)
    return phrase


def parse_csv_to_list(csv_file: str, w_duration: bool = True):
    """Parse the all-in-one dataset CSV into parallel lists.

    Returns ``(vids, titles, durations, timestamps)`` (or without durations
    when ``w_duration`` is False). ``timestamps`` is a list of lists of
    chapter lines (split on TIMESTAMP_DELIMITER).


    Copied from video_chapter_generation_tpu/datasetkit/parsing.py:118.
    """
    import pandas as pd

    data = pd.read_csv(
        csv_file, on_bad_lines="skip", engine="python", encoding="utf-8", sep=","
    )

    vids = list(data["videoId"].values) if "videoId" in data.columns else []
    titles = list(data["title"].values) if "title" in data.columns else []
    durations = (
        list(data["duration"].values)
        if (w_duration and "duration" in data.columns)
        else []
    )
    if "timestamp" in data.columns:
        timestamps = [
            x.split(TIMESTAMP_DELIMITER) if isinstance(x, str) else []
            for x in data["timestamp"].values
        ]
    else:
        timestamps = []

    if w_duration:
        return vids, titles, durations, timestamps
    return vids, titles, timestamps


def parse_timestamp_lines(lines: Sequence[str]) -> Tuple[List[int], List[str]]:
    """Parse raw chapter lines into (start_seconds, description) pairs.

    Copied from video_chapter_generation_tpu/datasetkit/parsing.py:151.
    """
    secs: List[int] = []
    descs: List[str] = []
    for line in lines:
        sec, desc = extract_first_timestamp(line)
        secs.append(sec)
        descs.append(desc)
    return secs, descs
