"""Dataset downloaders: YouTube videos (yt-dlp) and OneDrive share links.

The port's own copy of ``workoutdetector_tpu/scripts/download.py``.
``yt-dlp`` is imported only by ``download_ytb``, which raises a
RuntimeError naming it where it is not installed; a file already present
is not fetched again.
"""

from __future__ import annotations

import base64
import os
import os.path as osp
from typing import Optional


SHARES_API = "https://api.onedrive.com/v1.0/shares/u!"


def parse_onedrive(link: str) -> str:
    """OneDrive share link → direct-download URL: the shares API's item
    for the link's base64 token, its ``root``'s ``content``.

    >>> parse_onedrive('https://1drv.ms/u/s!AAAA').startswith(SHARES_API)
    True
    """
    assert link.startswith("https://1drv.ms/u/s!"), "not a OneDrive share link"
    token = base64.urlsafe_b64encode(link.strip().encode("ascii")).decode("ascii")
    return "/".join((SHARES_API + token, "root", "content"))


def download_ytb(url: str, folder: str = "~") -> Optional[str]:
    """One YouTube video at ≤ 720p as ``{folder}/{id}.mp4`` (the URL's last
    11 characters); skipped where the file exists."""
    folder = osp.expanduser(folder)
    vid = url[-11:]
    out = osp.join(folder, f"{vid}.mp4")
    if osp.exists(out):
        return out
    try:
        import yt_dlp
    except ImportError as e:
        raise RuntimeError(
            "yt-dlp is not installed; dataset videos must be provisioned "
            "another way (e.g. mounted or copied in)") from e
    opts = {
        "outtmpl": out,
        "quiet": True,
        "ignoreerrors": True,
        "format": "bv[height<=720]",
    }
    with yt_dlp.YoutubeDL(opts) as ydl:
        ydl.download([url])
    return out if osp.exists(out) else None


def download_countix(csv_path: str, folder: str) -> None:
    """Every ``video_id`` of a Countix CSV not yet in ``folder``."""
    import pandas as pd
    os.makedirs(osp.expanduser(folder), exist_ok=True)
    df = pd.read_csv(csv_path)
    for vid in df["video_id"].unique():
        if osp.exists(osp.join(osp.expanduser(folder), f"{vid}.mp4")):
            continue
        download_ytb(f"https://www.youtube.com/watch?v={vid}", folder)


def download_and_extract(url: str, download_root: str, filename: str,
                         extract_root: Optional[str] = None) -> None:
    """Fetch an archive (unless ``download_root/filename`` exists) and
    unzip it into ``extract_root`` (default ``download_root``)."""
    import urllib.request
    import zipfile

    os.makedirs(download_root, exist_ok=True)
    archive = osp.join(download_root, filename)
    if not osp.exists(archive):
        urllib.request.urlretrieve(url, archive)
    with zipfile.ZipFile(archive) as z:
        z.extractall(extract_root or download_root)
