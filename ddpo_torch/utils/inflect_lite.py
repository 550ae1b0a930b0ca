"""Tiny replacement for the `inflect` dependency (not available here).

Covers exactly what the prompt functions use (reference
ddpo/training/prompts.py:177-204): indefinite articles, small-number words,
and pluralization of simple animal nouns.
"""

from __future__ import annotations

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]

_IRREGULAR_PLURALS = {
    "goose": "geese",
    "mouse": "mice",
    "wolf": "wolves",
    "sheep": "sheep",
    "deer": "deer",
    "ox": "oxen",
    "fish": "fish",
    "octopus": "octopuses",
    "platypus": "platypuses",
    "bison": "bison",
    "moose": "moose",
    "goldfish": "goldfish",
    "jellyfish": "jellyfish",
}

_VOWEL_SOUND_EXCEPTIONS_AN = {"hour", "honest", "heir", "honor"}
_VOWEL_LETTER_EXCEPTIONS_A = {"unicorn", "european", "one", "once", "ukulele"}


def a(phrase: str) -> str:
    """'a dog' / 'an elephant' — indefinite article + phrase."""
    word = phrase.split()[0].lower()
    starts_vowel = word[0] in "aeiou"
    if word in _VOWEL_SOUND_EXCEPTIONS_AN or any(
        word.startswith(w) for w in _VOWEL_SOUND_EXCEPTIONS_AN
    ):
        article = "an"
    elif word in _VOWEL_LETTER_EXCEPTIONS_A or any(
        word.startswith(w) for w in _VOWEL_LETTER_EXCEPTIONS_A
    ):
        article = "a"
    else:
        article = "an" if starts_vowel else "a"
    return f"{article} {phrase}"


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + ("-" + _UNITS[rem] if rem else "")
    if n < 1000:
        hundreds, rem = divmod(n, 100)
        out = _UNITS[hundreds] + " hundred"
        return out + (" " + number_to_words(rem) if rem else "")
    raise ValueError(f"number_to_words supports < 1000, got {n}")


def plural(noun: str) -> str:
    lower = noun.lower()
    if lower in _IRREGULAR_PLURALS:
        result = _IRREGULAR_PLURALS[lower]
    elif lower.endswith(("s", "x", "z", "ch", "sh")):
        result = noun + "es"
    elif lower.endswith("y") and len(lower) > 1 and lower[-2] not in "aeiou":
        result = noun[:-1] + "ies"
    else:
        result = noun + "s"
    return result
