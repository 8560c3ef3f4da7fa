"""Danbooru tag formatting (``vision_ft_tpu/dataset/tags.py`` counterpart)."""

from __future__ import annotations


def _num_object(num: int, noun: str) -> str:
    return f"{num}{'+' if num == 6 else ''}{noun}{'s' if num > 1 else ''}"


PEOPLE_TAGS = [
    *[_num_object(i, "girl") for i in range(1, 7)],
    *[_num_object(i, "boy") for i in range(1, 7)],
    *[_num_object(i, "other") for i in range(1, 7)],
]


def format_general_character_tags(
    general: list[str],
    character: list[str],
    rating: str,
    separator: str = ", ",
    group_separator: str = "|||",
) -> str:
    """people ||| characters ||| general. The JAX package's quirk
    kept: rating tags are computed but NOT included in the
    output, as in the JAX package, so both give the same captions."""
    people_tags = []
    general_tags = []
    for tag in general:
        (people_tags if tag in PEOPLE_TAGS else general_tags).append(tag)

    rating_tags = []
    if rating in ("explicit", "e", "questionable", "q"):
        rating_tags.append("nsfw")
        if rating in ("explicit", "e"):
            rating_tags.append("explicit")
    else:
        rating_tags.append("safe")

    return group_separator.join(
        part
        for part in [
            separator.join(people_tags),
            separator.join(character),
            separator.join(general_tags),
        ]
        if part.strip() != ""
    )


KAOMOJI = [
    ">_<", ">_o", "0_0", "o_o", "3_3", "6_9", "@_@", "u_u", "x_x", "^_^",
    "|_|", "=_=", "+_+", "+_-", "._.", "<o>_<o>", "<|>_<|>",
    "||_||", "(o)_(o)",  # deprecated
]


def replace_underscore(tag: str) -> str:
    if tag in KAOMOJI:
        return tag
    return tag.replace("_", " ")


def map_replace_underscore(tags: list[str]) -> list[str]:
    return [replace_underscore(tag) for tag in tags]
