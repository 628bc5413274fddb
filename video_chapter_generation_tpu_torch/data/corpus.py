"""VideoCorpus: the on-disk dataset contract shared by every dataset class.

The port's own copy of video_chapter_generation_tpu/data/corpus.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence
from ..datasetkit.parsing import extract_first_timestamp, parse_csv_to_list


@dataclass
class VideoRecord:
    """Copied from video_chapter_generation_tpu/data/corpus.py:25."""
    vid: str
    title: str
    duration: float
    timestamp_lines: List[str]
    subtitles: Optional[List[Dict]] = None  # lazy unless in-memory
    image_num: Optional[int] = None


class VideoCorpus:
    """Copied from video_chapter_generation_tpu/data/corpus.py:34."""
    def __init__(self, records: Dict[str, VideoRecord], vids: List[str],
                 img_dir: str = "", asr_files: Optional[Dict[str, str]] = None):
        self.records = records
        self.vids = [v for v in vids if v in records]
        self.img_dir = img_dir
        self.asr_files = asr_files or {}

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_files(cls, img_dir: str, data_file: str, vid_file: str,
                   subtitle_dir: Optional[str] = None) -> "VideoCorpus":
        all_vids, titles, durations, timestamps = parse_csv_to_list(data_file)
        records = {}
        for i, vid in enumerate(all_vids):
            records[vid] = VideoRecord(
                vid=vid, title=titles[i],
                duration=float(durations[i]) if durations else 0.0,
                timestamp_lines=timestamps[i],
            )
        with open(vid_file) as f:
            vids = [x.strip() for x in f if x.strip()]
        subtitle_path = subtitle_dir or os.path.dirname(data_file)
        asr_files = {}
        for asr_file in glob.glob(subtitle_path + "/*/subtitle_*.json"):
            v = os.path.basename(asr_file).split(".")[0][9:]
            asr_files[v] = asr_file
        return cls(records, vids, img_dir, asr_files)

    @classmethod
    def from_memory(cls, videos: Sequence[Dict]) -> "VideoCorpus":
        """videos: [{vid, title, duration, timestamp_lines, subtitles,
        image_num}] — no filesystem."""
        records, vids = {}, []
        for v in videos:
            records[v["vid"]] = VideoRecord(
                vid=v["vid"], title=v.get("title", ""),
                duration=float(v.get("duration", v["image_num"])),
                timestamp_lines=list(v["timestamp_lines"]),
                subtitles=list(v["subtitles"]),
                image_num=int(v["image_num"]),
            )
            vids.append(v["vid"])
        return cls(records, vids, img_dir="")

    # -- per-video access ---------------------------------------------------
    def subtitles(self, vid: str) -> List[Dict]:
        rec = self.records[vid]
        if rec.subtitles is None:
            with open(self.asr_files[vid]) as f:
                rec.subtitles = json.load(f)
        return rec.subtitles

    def image_num(self, vid: str) -> int:
        rec = self.records[vid]
        if rec.image_num is None:
            rec.image_num = len(
                glob.glob(os.path.join(self.img_dir, vid) + "/*.jpg")
            )
        return rec.image_num

    def raw_cut_secs(self, vid: str) -> List[int]:
        return [
            extract_first_timestamp(line)[0]
            for line in self.records[vid].timestamp_lines
        ]

    def chapter_descriptions(self, vid: str):
        """[(start_sec, description_text)] for the title-generation task."""
        out = []
        for line in self.records[vid].timestamp_lines:
            sec, desc = extract_first_timestamp(line)
            out.append((sec, desc))
        return out

    def frame_path(self, vid: str, index_1based: int) -> str:
        return os.path.join(self.img_dir, vid, "%05d.jpg" % index_1based)

    def __len__(self) -> int:
        return len(self.vids)
