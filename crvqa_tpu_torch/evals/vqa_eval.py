"""Official-style VQA evaluation with answer normalization (counterpart of
`crvqa_tpu/evals/vqa_eval.py`).

The standard VQA v2 evaluation protocol of `mPLUG/vqaTools/{vqa.py,
vqaEval.py}`: fully normalize the predicted answer (punctuation rules, then
contractions / digit words / article stripping); ground-truth answers get
only the punctuation pass and only when the ten humans disagree (the
official protocol's asymmetry, vqaEval.py:93-97). Each prediction scores
min(#matching-humans / 3, 1) leave-one-out, aggregated overall and per
question type / answer type. Host code only: no torch, no device.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = ("a", "an", "the")

PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


class VQAEval:
    """Official evaluate loop: for each question score the prediction
    min(#gt-humans-matching / 3, 1) against the 10 human answers, with
    overall / per-question-type / per-answer-type aggregates."""

    def __init__(self, n: int = 2):
        self.n = n
        self.accuracy: dict = {}
        self.eval_qa: dict = {}
        self.eval_ques_type: dict = {}
        self.eval_ans_type: dict = {}

    def evaluate(self, predictions: Sequence[dict],
                 annotations: Sequence[dict]) -> dict:
        """predictions: [{question_id, answer}]; annotations:
        [{question_id, answers: [{'answer': str}...], question_type,
        answer_type}].

        Leave-one-out is by index — equal to the reference's whole-dict
        `item != gtAnsDatum` exclusion (vqaEval.py:98) on real VQA
        annotation files, whose answer dicts are pairwise distinct
        (answer_id 1..10). On stripped duplicate dicts the reference
        excludes ALL copies at once (unanimous GT scores 0 no matter the
        prediction) — a degenerate-input artifact we do not reproduce,
        as the JAX package's VQAEval does not."""
        pred_by_id = {p["question_id"]: p["answer"] for p in predictions}
        acc_qa: list[float] = []
        acc_ques_type: dict[str, list] = {}
        acc_ans_type: dict[str, list] = {}
        for anno in annotations:
            qid = anno["question_id"]
            if qid not in pred_by_id:
                continue
            res_ans = normalize_answer(pred_by_id[qid])
            # official-protocol asymmetry (vqaEval.py:93-97): ground-truth
            # answers get processPunctuation ONLY when the humans disagree,
            # and NEVER processDigitArticle — e.g. pred "2" does NOT match
            # GT "two". As in the JAX package's VQAEval.
            gts = [a["answer"] if isinstance(a, dict) else a
                   for a in anno["answers"]]
            if len(set(gts)) > 1:
                gts = [process_punctuation(g) for g in gts]
            # official leave-one-out: average over subsets excluding each human
            accs = []
            for i in range(len(gts)):
                other = gts[:i] + gts[i + 1:]
                matching = sum(1 for g in other if g == res_ans)
                accs.append(min(1.0, matching / 3.0))
            avg = sum(accs) / len(accs) if accs else 0.0
            acc_qa.append(avg)
            self.eval_qa[qid] = round(100 * avg, self.n)
            qt = anno.get("question_type", "")
            at = anno.get("answer_type", "")
            acc_ques_type.setdefault(qt, []).append(avg)
            acc_ans_type.setdefault(at, []).append(avg)
        self.accuracy = {
            "overall": round(100 * sum(acc_qa) / len(acc_qa), self.n)
            if acc_qa else 0.0,
            "perQuestionType": {
                k: round(100 * sum(v) / len(v), self.n)
                for k, v in acc_ques_type.items()},
            "perAnswerType": {
                k: round(100 * sum(v) / len(v), self.n)
                for k, v in acc_ans_type.items()},
        }
        return self.accuracy
