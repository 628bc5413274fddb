"""Topic/query tooling and one-off dataset helpers.

The port's own copy of video_chapter_generation_tpu/datasetkit/topics.py
(each definition names the line it was copied from), so the port never
imports the JAX package. The reference's last peripheral scripts as pure,
testable functions (the originals are filesystem/network one-offs):
- wikihow topic scraping + query->category assignment
  (get_topics_for_searching.py:33-134)
- video property fetch + chapter parse (get_youtube_video_property.py:15-41;
  the timestamp parser itself is `acquire.parse_timestamp_block`)
- annotation URL listing (annotate_minidataset.py:1-15)
- frame resizing (resize_image.py:1-17) — PIL instead of cv2.

Network and filesystem access are injectable (`http_get`), matching
acquire.py's offline-testable style.

Two differences from the JAX copy, where it raises:
- `categorize_vids` files a `valid_vids` entry that has no subtitle file
  (so no search query) under "unknown", where the JAX copy raises
  KeyError;
- `fetch_video_chapters` without an `http_get` reads the JSON body of
  the `requests` response, where the JAX copy calls `.get` on the
  response object and raises AttributeError.
"""

from __future__ import annotations

import os
from html.parser import HTMLParser
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .acquire import parse_timestamp_block

WIKIHOW_WEBSITE = "https://www.wikihow.com/"

# the reference's fixed subject list (get_topics_for_searching.py:12-30;
# JAX topics.py:28)
WIKIHOW_SUBJECTS = [
    "Category:Arts-and-Entertainment",
    "Category:Cars-%26-Other-Vehicles",
    "Category:Computers-and-Electronics",
    "Category:Education-and-Communications",
    "Category:Family-Life",
    "Category:Finance-and-Business",
    "Category:Food-and-Entertaining",
    "Category:Health",
    "Category:Hobbies-and-Crafts",
    "Category:Holidays-and-Traditions",
    "Category:Home-and-Garden",
    "Category:Personal-Care-and-Style",
    "Category:Pets-and-Animals",
    "Category:Sports-and-Fitness",
    "Category:Travel",
    "Category:Work-World",
    "Category:Youth",
]


class _ThumbTitleParser(HTMLParser):
    """Extracts the text of <div class="responsive_thumb_title"> elements
    (the "How to ..." article titles on a wikihow category page).

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:49.
    """

    def __init__(self):
        super().__init__()
        self._depth = 0
        self._parts: List[str] = []
        self.titles: List[str] = []

    def handle_starttag(self, tag, attrs):
        if self._depth > 0:
            if tag == "div":
                self._depth += 1
            return
        if tag == "div":
            classes = dict(attrs).get("class", "") or ""
            if "responsive_thumb_title" in classes.split():
                self._depth = 1
                self._parts = []

    def handle_endtag(self, tag):
        if self._depth > 0 and tag == "div":
            self._depth -= 1
            if self._depth == 0:
                text = "".join(self._parts)
                self.titles.append(" ".join(text.split()))

    def handle_data(self, data):
        if self._depth > 0:
            self._parts.append(data)


def parse_wikihow_titles(html: str) -> List[str]:
    """One category page's HTML -> article-title queries, whitespace
    normalized exactly like the reference (split + rejoin,
    get_topics_for_searching.py:44-50).

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:82.
    """
    p = _ThumbTitleParser()
    p.feed(html)
    return p.titles


def scrape_wikihow_queries(
    subjects: Optional[Sequence[str]] = None,
    http_get: Optional[Callable[[str], Optional[str]]] = None,
) -> Dict[str, List[str]]:
    """category -> ["How to ...", ...] per wikihow subject page.
    `http_get(url) -> html or None` is injectable for offline tests.

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:91.
    """
    if http_get is None:
        def http_get(url):
            import requests

            resp = requests.get(url)
            return resp.content.decode("utf-8") if resp.status_code == 200 \
                else None

    category2query: Dict[str, List[str]] = {}
    for subject in subjects if subjects is not None else WIKIHOW_SUBJECTS:
        html = http_get(WIKIHOW_WEBSITE + subject)
        if html is None:
            continue
        category2query[subject] = parse_wikihow_titles(html)
    return category2query


def assign_query_categories(
    queries: Sequence[str], category2query: Dict[str, List[str]]
) -> Tuple[Dict[str, str], Dict[str, int]]:
    """Each query -> its first matching category, "unknown" otherwise;
    returns (query2category, per-category counts)
    (get_topics_for_searching.py:68-87).

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:114.
    """
    counts: Dict[str, int] = {"unknown": 0}
    query2category: Dict[str, str] = {}
    for q in queries:
        for cat, qs in category2query.items():
            if q in qs:
                counts[cat] = counts.get(cat, 0) + 1
                query2category[q] = cat
                break
        else:
            counts["unknown"] += 1
            query2category[q] = "unknown"
    return query2category, counts


def subtitle_path_query(path: str) -> Tuple[str, str]:
    """dataset/<query>/subtitle_<vid>.json -> (query, vid)
    (get_topics_for_searching.py:96-101).

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:134.
    """
    parts = path.replace(os.sep, "/").split("/")
    query = parts[-2]
    vid = os.path.basename(path)[9:-5]
    return query, vid


def categorize_vids(
    subtitle_paths: Sequence[str],
    query2category: Dict[str, str],
    valid_vids: Optional[Sequence[str]] = None,
) -> Dict[str, List[str]]:
    """category -> vids, via each vid's search query (its subtitle-file
    directory); restricted to `valid_vids` when given
    (get_topics_for_searching.py:96-125). A valid vid without a subtitle
    file has no query and goes under "unknown" (the JAX copy raises
    KeyError).

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:143.
    """
    vid2category: Dict[str, str] = {}
    for p in subtitle_paths:
        query, vid = subtitle_path_query(p)
        vid2category[vid] = query2category.get(query, "unknown")
    vids = list(valid_vids) if valid_vids is not None else list(vid2category)
    out: Dict[str, List[str]] = {}
    for vid in vids:
        out.setdefault(vid2category.get(vid, "unknown"), []).append(vid)
    return out


def _default_json_get(url: str, params: Dict) -> Optional[Dict]:
    """The JSON body of a `requests` GET (acquire._default_http_get; gated
    on requests), None when the status is not 200."""
    from .acquire import _default_http_get

    r = _default_http_get(url, params)
    return r.json() if getattr(r, "status_code", 200) == 200 else None


def fetch_video_chapters(
    vid: str, api_key: str,
    http_get: Optional[Callable[[str, Dict], Dict]] = None,
) -> List[str]:
    """Video id -> chapter timestamp lines from its description via the
    Data API snippet endpoint (get_youtube_video_property.py:36-41); the
    line parser is the shared `parse_timestamp_block`. http_get(url,
    params) returns the decoded JSON (or None); without one the request
    goes through `requests` (the JAX copy passes the response object on
    undecoded and raises there).

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:162.
    """
    if http_get is None:
        http_get = _default_json_get
    data = http_get(
        "https://www.googleapis.com/youtube/v3/videos",
        {"part": "snippet", "id": vid, "key": api_key},
    )
    items = (data or {}).get("items", [])
    if not items:
        return []
    return parse_timestamp_block(items[0]["snippet"]["description"])


def annotation_urls(vids_per_file: Dict[str, Sequence[str]],
                    per_file: int = 5) -> List[str]:
    """First `per_file` vids of each data.csv -> watch URLs for manual
    annotation (annotate_minidataset.py:6-14).

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:181.
    """
    urls = []
    for _, vids in sorted(vids_per_file.items()):
        for vid in list(vids)[:per_file]:
            urls.append(f"https://www.youtube.com/watch?v={vid}")
    return urls


def resize_frames(img_dir: str, target_size: int = 96,
                  pattern: str = "*.jpg") -> int:
    """Resize every frame JPEG in a video's directory in place
    (resize_image.py:8-17; PIL instead of cv2). Returns #files written.

    Copied from video_chapter_generation_tpu/datasetkit/topics.py:192.
    """
    import glob

    from PIL import Image

    n = 0
    for path in sorted(glob.glob(os.path.join(img_dir, pattern))):
        with Image.open(path) as img:
            resized = img.convert("RGB").resize((target_size, target_size))
        resized.save(path, quality=95)
        n += 1
    return n
