"""SMHI open-data radar downloader (reference: download_smhi_radar.py).

Builds the per-day composite zip URLs and fetches them with urllib.  URL
construction is pure (standard-library dates); only `download_range`
touches the network, and only when called.
"""

from __future__ import annotations

import datetime
import os
import zipfile
from typing import List

from prdisagg_torch.data.ingest import as_date

SMHI_URL = (
    "https://opendata-download-radar.smhi.se/api/version/latest/area/sweden/"
    "product/comp/{year}/{month}/{day}.zip?format=tif"
)


def day_urls(startdate: str, enddate: str) -> List[tuple]:
    """[(date_str YYYYMMDD, url), ...] for the inclusive date range
    (download_smhi_radar.py:6-9)."""
    day, end = as_date(startdate), as_date(enddate)
    out = []
    while day <= end:
        url = SMHI_URL.format(year=day.year, month=day.month, day=day.day)
        out.append((day.strftime("%Y%m%d"), url))
        day += datetime.timedelta(days=1)
    return out


def download_range(
    startdate: str,
    enddate: str,
    outpath: str,
    unzip: bool = True,
) -> List[str]:
    """Fetch daily zips; returns the list of failed dates (the radar archive
    is incomplete: failures are expected and skipped, like the reference's
    failed_dates collection in convert_smhi_radardata.py:47-52).  A failed
    date's zip is removed."""
    import urllib.request

    os.makedirs(outpath, exist_ok=True)
    failed = []
    for date_str, url in day_urls(startdate, enddate):
        zip_path = os.path.join(outpath, f"smhi_radar_{date_str}.zip")
        try:
            urllib.request.urlretrieve(url, zip_path)
            if unzip:
                with zipfile.ZipFile(zip_path) as z:
                    z.extractall(outpath)
                os.remove(zip_path)
        except Exception:  # noqa: BLE001 — a missing day fails that day only
            failed.append(date_str)
            if os.path.exists(zip_path):
                os.remove(zip_path)
    return failed
