"""Dataset acquisition: YouTube search, timestamp scraping, ASR fetch,
video download, frame extraction.

The port's own copy of video_chapter_generation_tpu/datasetkit/acquire.py
(each definition names the line it was copied from), so the port never
imports the JAX package. All network/binary-dependent steps are GATED:
they require the optional dependencies (requests + API key,
youtube_transcript_api, yt_dlp, the ffmpeg binary) at call time and raise
a RuntimeError naming the missing one otherwise; the parsing and
orchestration logic is importable and tested everywhere, with the HTTP
and ASR calls injected.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from .parsing import TIMESTAMP_DELIMITER, extract_timestamp

MAX_DURATION_SEC = 1800  # skip videos > 30 min (download_video_subtitle.py:26)
FRAME_SIZE = 224
FRAME_RATE = 1


def parse_description_timestamps(description: str) -> List[str]:
    """Extract chapter lines from a video description: lines containing a
    timestamp, joined downstream with TIMESTAMP_DELIMITER
    (make_video_chapter_dataset.py:46-64).

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:28.
    """
    lines = []
    for line in description.split("\n"):
        _, sec, si, _ = extract_timestamp(line)
        if sec >= 0:
            lines.append(line.strip())
    return lines


def timestamps_to_csv_cell(lines: Sequence[str]) -> str:
    """Copied from video_chapter_generation_tpu/datasetkit/acquire.py:40."""
    return TIMESTAMP_DELIMITER.join(lines)


def parse_timestamp_block(description: str) -> List[str]:
    """The scrape-time chapter parser, reproduced EXACTLY
    (make_video_chapter_dataset.py:45-64): the block must START with a line
    containing "0:00" (<=150 chars), continues while lines contain a m:ss
    pattern, and http urls are stripped from kept lines.

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:44.
    """
    timestamp_lines: List[str] = []
    for line in description.split("\n"):
        if len(line) > 150:
            continue
        if len(timestamp_lines) == 0 and "0:00" in line:
            timestamp_lines.append(re.sub(r"http\S+", "", line))
            continue
        if timestamp_lines and re.search(r"\d{1}:\d{2}", line):
            timestamp_lines.append(re.sub(r"http\S+", "", line))
    return timestamp_lines


# ---------------------------------------------------------------------------
# YouTube search + description/ASR fan-out (make_video_chapter_dataset.py)
# ---------------------------------------------------------------------------

YOUTUBE_SEARCH_URL = "https://www.googleapis.com/youtube/v3/search"
YOUTUBE_VIDEO_URL = "https://www.googleapis.com/youtube/v3/videos"
PUBLISHED_AFTER = "2020-05-01T00:00:00Z"


def _default_http_get(url: str, params: Dict):
    """Copied from video_chapter_generation_tpu/datasetkit/acquire.py:70."""
    try:
        import requests  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "requests not installed — YouTube search unavailable; pass "
            "http_get= for offline use"
        ) from e
    return requests.get(url + "?", params=params)


def _collect_search_items(videos: Dict[str, List], response: Dict) -> None:
    """save_result (make_video_chapter_dataset.py:34-43).

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:81.
    """
    for item in response.get("items", []):
        if item["id"]["kind"] == "youtube#video":
            videos["title"].append(item["snippet"]["title"])
            videos["description"].append(item["snippet"]["description"])
            videos["videoId"].append(item["id"]["videoId"])
            videos["publishedAt"].append(item["snippet"]["publishedAt"])
            videos["channelId"].append(item["snippet"]["channelId"])


def fetch_descriptions(vids: Sequence[str], api_key: str, http_get=None,
                       n_workers: int = 8):
    """Full-description fetch + timestamp parse, thread fan-out
    (subprocess_request_video_description, :67-88 — threads instead of
    processes: the work is pure IO). Returns (indices_with_timestamps,
    timestamp_line_lists) in original order.

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:92.
    """
    http_get = http_get or _default_http_get

    def work(pair):
        i, vid = pair
        r = http_get(YOUTUBE_VIDEO_URL,
                     {"part": "snippet", "key": api_key, "id": vid})
        if getattr(r, "status_code", 200) != 200:
            return None
        data = r.json()
        lines = parse_timestamp_block(
            data["items"][0]["snippet"]["description"]
        )
        return (i, lines) if lines else None

    with ThreadPoolExecutor(n_workers) as ex:
        results = list(ex.map(work, list(enumerate(vids))))
    kept = [r for r in results if r is not None]
    return [i for i, _ in kept], [lines for _, lines in kept]


def fetch_asr_many(vids: Sequence[str], n_workers: int = 8,
                   asr_fetch=None) -> List[List[Dict]]:
    """ASR fetch fan-out (subprocess_request_asr, :91-111); failures yield
    [] like the reference. asr_fetch is injectable for offline tests.

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:118.
    """
    asr_fetch = asr_fetch or fetch_asr

    def work(vid):
        try:
            return asr_fetch(vid) or []
        except Exception:
            return []

    with ThreadPoolExecutor(n_workers) as ex:
        return list(ex.map(work, vids))


def search_youtube_video(search_term: str, max_results: int, api_key: str,
                         http_get=None, asr_fetch=None, n_workers: int = 8,
                         published_after: str = PUBLISHED_AFTER) -> Dict:
    """YouTube Data API search -> description timestamp scrape -> ASR fetch
    (search_youtube_video, make_video_chapter_dataset.py:114-257).

    Appends " timestamp" to the query, paginates until max_results, keeps
    only videos whose full description parses to a chapter block, fetches
    their auto captions, and returns
    {videoId, title, subtitle, timestamp(joined)} parallel lists — the rows
    of a per-category data.csv. http_get/asr_fetch are injectable (offline
    tests use canned responses); the default http_get requires `requests`.

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:134.
    """
    http_get = http_get or _default_http_get
    videos: Dict[str, List] = {
        k: [] for k in
        ("title", "description", "videoId", "publishedAt", "channelId")
    }
    params = {
        "q": search_term + " timestamp",
        "part": "id,snippet",
        "maxResults": max_results,
        "key": api_key,
        "publishedAfter": published_after,
    }
    r = http_get(YOUTUBE_SEARCH_URL, params)
    if getattr(r, "status_code", 200) != 200:
        if "quota" in getattr(r, "text", ""):
            raise RuntimeError("YouTube API quota exceeded")
        return None
    response = r.json()
    _collect_search_items(videos, response)
    while len(videos["videoId"]) < max_results:
        token = response.get("nextPageToken")
        if token is None:
            break
        params["pageToken"] = token
        r = http_get(YOUTUBE_SEARCH_URL, params)
        if getattr(r, "status_code", 200) != 200:
            return None
        response = r.json()
        _collect_search_items(videos, response)

    indices, timestamps = fetch_descriptions(
        videos["videoId"], api_key, http_get, n_workers
    )
    subtitles = fetch_asr_many(
        [videos["videoId"][i] for i in indices], n_workers, asr_fetch
    )

    out: Dict[str, List] = {
        "videoId": [], "title": [], "subtitle": [], "timestamp": []
    }
    for k, i in enumerate(indices):
        out["videoId"].append(videos["videoId"][i])
        out["title"].append(videos["title"][i])
        out["subtitle"].append(subtitles[k])
        out["timestamp"].append(timestamps_to_csv_cell(timestamps[k]))
    return out


def is_chapter_video(description: str, min_chapters: int = 2) -> bool:
    """Copied from video_chapter_generation_tpu/datasetkit/acquire.py:195."""
    return len(parse_description_timestamps(description)) >= min_chapters


# ---------------------------------------------------------------------------
# gated network/binary stages
# ---------------------------------------------------------------------------


def fetch_asr(vid: str, languages=("en",)) -> Optional[List[Dict]]:
    """Auto captions via youtube_transcript_api (gated).

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:204.
    """
    try:
        from youtube_transcript_api import YouTubeTranscriptApi  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "youtube_transcript_api not installed — ASR fetch unavailable"
        ) from e
    try:
        return YouTubeTranscriptApi.get_transcript(vid, languages=languages)
    except Exception:
        return None


def download_video(vid: str, out_dir: str, fmt: str = "18") -> Optional[str]:
    """yt-dlp download, format 18 = 360p mp4 (download_video.py) (gated).

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:218.
    """
    try:
        import yt_dlp  # type: ignore
    except ImportError as e:
        raise RuntimeError("yt_dlp not installed — download unavailable") from e
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{vid}.mp4")
    opts = {"format": fmt, "outtmpl": out, "quiet": True}
    try:
        with yt_dlp.YoutubeDL(opts) as ydl:
            ydl.download([f"https://www.youtube.com/watch?v={vid}"])
        return out
    except Exception:
        return None


def extract_frames(video_path: str, out_dir: str, hw: int = FRAME_SIZE,
                   fps: int = FRAME_RATE) -> int:
    """ffmpeg -i vid.mp4 -s 224x224 -r 1 %05d.jpg
    (extract_video_to_frames.py:28) (gated on the ffmpeg binary).

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:235.
    """
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found — frame extraction unavailable")
    os.makedirs(out_dir, exist_ok=True)
    cmd = [
        "ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
        "-s", f"{hw}x{hw}", "-r", str(fps),
        os.path.join(out_dir, "%05d.jpg"),
    ]
    subprocess.run(cmd, check=True)
    return len([f for f in os.listdir(out_dir) if f.endswith(".jpg")])


def extract_frames_many(video_paths: Sequence[str], out_root: str,
                        n_workers: int = 8) -> Dict[str, int]:
    """Thread-pool fan-out over videos (extract_video_to_frames.py:47-55).

    Copied from video_chapter_generation_tpu/datasetkit/acquire.py:251.
    """
    results: Dict[str, int] = {}

    def work(path):
        vid = os.path.splitext(os.path.basename(path))[0]
        results[vid] = extract_frames(path, os.path.join(out_root, vid))

    with ThreadPoolExecutor(n_workers) as ex:
        list(ex.map(work, video_paths))
    return results
