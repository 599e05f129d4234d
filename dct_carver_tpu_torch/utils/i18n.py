"""Message catalogs for user-facing strings (SURVEY §2.9).

The reference ships gettext plumbing with an EMPTY language list
(`configure.in:81` ALL_LINGUAS="", `po/POTFILES` listing
interface.c/main.c/render.c) — the translatable surface exists but no
translation does.  Here the same surface (progress messages from
`src/render.c:117-118` / `src/interface.c:129`, the dialog labels from
`src/interface.c:310-466`, and the CLI's user-facing errors) is backed by
actual catalogs, loaded from JSON files in `dct_carver_tpu_torch/locale/`
(copies of the JAX package's, `dct_carver_tpu/utils/i18n.py`).

Usage::

    from dct_carver_tpu_torch.utils.i18n import _, set_language
    set_language("de")          # or env DCT_CARVER_LANG / LANG
    _("Resizing width...")      # -> "Breite wird angepasst..."

Unknown languages and untranslated strings fall back to the English
message itself (gettext semantics: the msgid IS the English text).
"""

from __future__ import annotations

import json
import os

__all__ = ["_", "set_language", "set_language_from_env", "get_language",
           "available_languages"]

_LOCALE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "locale")

_catalog: dict[str, str] = {}
_language = "en"


def available_languages() -> list[str]:
    langs = ["en"]
    if os.path.isdir(_LOCALE_DIR):
        langs += sorted(
            f[:-5] for f in os.listdir(_LOCALE_DIR) if f.endswith(".json")
        )
    return langs


def set_language(lang: str | None) -> str:
    """Select the active language ('en' or a catalog in locale/).  Returns
    the language actually selected (falls back to 'en')."""
    global _catalog, _language
    lang = (lang or "en").split(".")[0].split("_")[0].lower()
    path = os.path.join(_LOCALE_DIR, f"{lang}.json")
    if lang != "en" and os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            _catalog = json.load(f)
        _language = lang
    else:
        _catalog = {}
        _language = "en"
    return _language


def get_language() -> str:
    return _language


def _(msg: str) -> str:
    """Translate `msg` in the active catalog; identity for English or any
    untranslated message."""
    return _catalog.get(msg, msg)


def set_language_from_env() -> str:
    """Select the language from DCT_CARVER_LANG, falling back to LANG (how
    the plugin inherits GIMP's locale).  Called by the CLI/UI entry points;
    library imports honor only the explicit opt-in below."""
    return set_language(
        os.environ.get("DCT_CARVER_LANG") or os.environ.get("LANG"))


# At import time only the package-specific opt-in applies: merely importing
# the library must not translate a consumer's progress strings because their
# process happens to run under LANG=de_DE (plain LANG is honored by the
# CLI/UI entry points via `set_language_from_env`).
set_language(os.environ.get("DCT_CARVER_LANG"))
