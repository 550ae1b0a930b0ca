"""Prompt functions: name-addressed generators of (inference, training, meta).

Public surface matches the reference registry (ddpo/training/prompts.py):
each prompt_fn returns (inference_prompt, training_prompts, metadata);
make_prompts(fn_name, batch_size, identical_batch, **kwargs) draws a batch —
independent draws, or one draw repeated across the batch (reference
batchify/batchify_identical :14-34).
"""

from __future__ import annotations

import random

from ddpo_torch.utils import inflect_lite as inflect
from ddpo_torch.utils.imagenet import imagenet_classes, imagenet_colors
from ddpo_torch.utils.loaders import load_general_prompts, load_lines

# --------------------------------- general api -------------------------------- #


def batchify(prompt_fn, batch_size, **kwargs):
    inference, training, metadata = zip(
        *[prompt_fn(**kwargs) for _ in range(batch_size)]
    )
    return list(inference), list(training), list(metadata)


def batchify_identical(prompt_fn, batch_size, **kwargs):
    inference, training, metadata = prompt_fn(**kwargs)
    return (
        [inference] * batch_size,
        [training] * batch_size,
        [metadata] * batch_size,
    )


def make_prompts(fn_name: str, batch_size: int, identical_batch: bool = False, **kwargs):
    prompt_fn = PROMPT_FNS[fn_name]
    if identical_batch:
        return batchify_identical(prompt_fn, batch_size, **kwargs)
    return batchify(prompt_fn, batch_size, **kwargs)


def _random_class(idx=None, low=None, high=None):
    classes = imagenet_classes()
    if idx is not None:
        return classes[idx]
    if low is not None and high is not None:
        return classes[random.randint(low, high)]
    return random.choice(classes)


# ---------------------------- specific experiments ---------------------------- #


def person_pet(evaluate=False):
    training = ["a photo of a person with their pet"]
    return random.choice(training), training, {}


def consistent_animals(evaluate=False):
    prompt = "a husky and a shoebill stork on the beach in a single image"
    return prompt, [prompt], {}


def consistent_imagenet_animals(colors=False):
    c1, c2 = _random_class(), _random_class()
    if colors:
        col = lambda: random.choice(imagenet_colors())
        prompt = f"a realistic photo of a {col()} {c1} and a {col()} {c2}"
    else:
        prompt = f"a realistic photo of a {c1} and a {c2}"
    return prompt, [prompt], {}


def consistent_imagenet_animals_3(colors=False):
    c1, c2, c3 = _random_class(), _random_class(), _random_class()
    if colors:
        col = lambda: random.choice(imagenet_colors())
        prompt = (
            f"a realistic photo of a {col()} {c1}, a {col()} {c2}, "
            f"and a {col()} {c3}"
        )
    else:
        prompt = f"a realistic photo of a {c1}, a {c2}, and a {c3}"
    return prompt, [prompt], {}


def n_fingers(evaluate=False):
    n = random.randint(1, 4)
    prompt = f'a photo of a hand holding up {n} finger{"s" if n > 1 else ""}'
    return prompt, [prompt], {}


def imagenet_single(evaluate=False, idx=None):
    prompt = f"a realistic photo of a {_random_class(idx=idx)}"
    return prompt, [prompt], {}


def imagenet_aesthetic(evaluate=False):
    training = [f"a realistic photo of a {_random_class()}"]
    return random.choice(training), training, {}


def imagenet_simple(evaluate=False, idx=None):
    prompt = f"a {_random_class(idx=idx)}"
    return prompt, [prompt], {}


def imagenet_dogs(evaluate=False, idx=None):
    training = [f"{_random_class(idx=idx, low=151, high=268)}"]
    return random.choice(training), training, {}


def animal_debug(evaluate=False, idx=None):
    """Deterministic fixed-prompt smoke fixture (reference :132-135)."""
    training = ["a peacock"]
    return random.choice(training), training, {}


def simple_dogs(evaluate=False, idx=None):
    training = [f"{_random_class(idx=idx, low=151, high=268)}"]
    return random.choice(training), training, {}


def imagenet_animals(evaluate=False, idx=None):
    """Animal classes 0-397: the compressed-animals workload."""
    training = [f"{_random_class(idx=idx, low=0, high=397)}"]
    return random.choice(training), training, {}


def from_file(loadpath, evaluate=False, idx=None):
    prompts = load_lines(loadpath)
    prompt = prompts[idx] if idx is not None else random.choice(prompts)
    return prompt, [prompt], {}


def vqa_dataset(loadpath, max_samples=None, evaluate=False):
    entry = random.choice(load_general_prompts(loadpath))
    return entry["prompt"], [entry["prompt"]], entry


def manual(prompts, evaluate=False):
    return random.choice(prompts), prompts, {}


def nouns_activities(nouns_path, activities_path, evaluate=False):
    nouns = load_lines(nouns_path)
    activities = load_lines(activities_path)
    prompt = f"{inflect.a(random.choice(nouns))} {random.choice(activities)}"
    return prompt, [prompt], {}


def counting(nouns_path, number_range, evaluate=False):
    nouns = load_lines(nouns_path)
    number = inflect.number_to_words(random.randint(*number_range))
    noun = random.choice(nouns)
    plural_noun = inflect.plural(noun)
    prompt = f"{number} {plural_noun}"
    metadata = {
        "questions": [
            f"How many {plural_noun} are there in this image?",
            "What animal is in this image?",
        ],
        "answers": [number, noun],
    }
    return prompt, [prompt], metadata


PROMPT_FNS = {
    fn.__name__: fn
    for fn in [
        person_pet,
        consistent_animals,
        consistent_imagenet_animals,
        consistent_imagenet_animals_3,
        n_fingers,
        imagenet_single,
        imagenet_aesthetic,
        imagenet_simple,
        imagenet_dogs,
        animal_debug,
        simple_dogs,
        imagenet_animals,
        from_file,
        vqa_dataset,
        manual,
        nouns_activities,
        counting,
    ]
}
